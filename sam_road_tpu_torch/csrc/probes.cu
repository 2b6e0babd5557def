// The row max of a batched product, out[b, n] = bf16(max_m sum_c a[b, n, c]
// b[b, m, c]): the CUDA kernel behind the probe kernels T7 (batched_dot) and
// T8 (lane_slice) of sam_road_tpu_torch/tools/probe_mosaic.py.
//
// T7 replaces tools/probe_mosaic.py::batched_dot: a leading-batch
// dot_general q.q^T over q [32, 200, 64], then each row's max -> [32, 200].
// T8 replaces tools/probe_mosaic.py::lane_slice as its comment means it (a
// 64-column head split of a qkv-wide row): a = x[b][:, 0:64], b =
// x[b][:, 64:128] of x [8, 200, 768], then the row max of a.b^T -> [8, 200].
// (The Pallas body as written slices the token axis of its (1, 200, 768)
// block and its dot then fails to trace on every backend.) On the TPU each
// probe asks whether Mosaic lowers a construct; here the kernel reads its
// operands through a row stride, a batch stride and a column offset, so the
// head split is an address and T8 reads only 128 of the 768 columns.
//
// What bounds it on the H100: nothing but launch latency. T7 is 164 MFLOP
// against 0.8 MB (0.25 us at the HBM peak), T8 41 MFLOP against the 0.41 MB
// of its two heads and its output (0.12 us). One block per (image, 64-query tile), 4 warps of 16 query
// rows; the 64-row key tiles stream through shared memory, the 16 x 16
// wmma score tiles (bf16 in, fp32 accumulate) go through a per-warp staging
// tile, and each query row keeps a running max over the real keys (the rows
// are padded to 16: pad keys never enter the max, pad queries are never
// written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;          // the contraction depth (a head)
constexpr int BQ = 64, BKV = 64;
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDT = D + 8;     // bf16 tile row stride

struct Operand {
  const bf16* p;               // element (0, 0, 0) of the tensor
  int64_t row, batch;          // strides, in elements
  int col;                     // the first of the D columns read
};

// rows [r0, r0 + 64) of image b's operand into dst; rows from N on are zero
__device__ __forceinline__ void load_rows(bf16 (*dst)[LDT], const Operand& o, int b, int r0,
                                          int N, int tid) {
  for (int e = tid; e < 64 * (D / 8); e += THREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N)
      u = *reinterpret_cast<const uint4*>(o.p + b * o.batch + (r0 + r) * o.row + o.col + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = u;
  }
}

__global__ void __launch_bounds__(THREADS)
rowmax_dot_kernel(Operand qa, Operand kb, bf16* __restrict__ out, int N) {
  __shared__ __align__(128) bf16 Qs[BQ][LDT];
  __shared__ __align__(128) bf16 Ks[BKV][LDT];
  __shared__ __align__(128) float stage[WARPS][16][16];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  // lane -> query row r of the warp's strip, columns [half * 8, half * 8 + 8) of a tile
  const int r = lane & 15, half = lane >> 4;
  float mx = -INFINITY;

  load_rows(Qs, qa, b, q0, N, tid);
  for (int k0 = 0; k0 < N; k0 += BKV) {
    __syncthreads();  // the previous key tile is consumed (and the q tile is in)
    load_rows(Ks, kb, b, k0, N, tid);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < BKV / 16; ++t) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d = 0; d < D; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, &Qs[warp * 16][d], LDT);
        wmma::load_matrix_sync(fb, &Ks[t * 16][d], LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&stage[warp][0][0], acc, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int m = half * 8 + c;
        if (k0 + t * 16 + m < N) mx = fmaxf(mx, stage[warp][r][m]);
      }
      __syncwarp();
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
  const int n = q0 + warp * 16 + r;
  if (half == 0 && n < N) out[(int64_t)b * N + n] = __float2bfloat16_rn(mx);
}

}  // namespace

extern "C" {

// out [B, N] bf16 = max over m < N of a[b, n, :] . b[b, m, :], the D = 64
// columns from a_col / b_col on; a and b (which may be one tensor) bf16,
// token rows row_stride elements apart and images batch_stride apart, every
// stride and offset a multiple of 8 (16-byte loads).
int samroad_rowmax_dot(const void* a, const void* b, void* out, int B, int N, int depth,
                       int row_stride, int batch_stride, int a_col, int b_col, void* stream) {
  if (B <= 0 || N <= 0 || depth != D || row_stride % 8 || batch_stride % 8 || a_col % 8 ||
      b_col % 8 || a_col < 0 || b_col < 0 || a_col + D > row_stride || b_col + D > row_stride)
    return (int)cudaErrorInvalidValue;
  const Operand qa{reinterpret_cast<const bf16*>(a), row_stride, batch_stride, a_col};
  const Operand kb{reinterpret_cast<const bf16*>(b), row_stride, batch_stride, b_col};
  dim3 grid((N + BQ - 1) / BQ, B);
  rowmax_dot_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      qa, kb, reinterpret_cast<bf16*>(out), N);
  return (int)cudaGetLastError();
}

}  // extern "C"
