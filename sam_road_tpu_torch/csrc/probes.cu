// The probe kernels of the port's tools: the CUDA counterparts of the Pallas
// kernels in tools/probe_mosaic.py (T7, T8), tools/probe_nondiv_blocks.py
// (T9-T12) and tools/repro_aot_crash.py (T13).
//
// rowmax_dot, the row max of a batched product, out[b, n] = bf16(max_m
// sum_c a[b, n, c] b[b, m, c]), behind T7 (batched_dot) and T8 (lane_slice)
// of sam_road_tpu_torch/tools/probe_mosaic.py.
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
//
// row_block_affine (T9, T10), window_colsum (T11, T12) and batched_nt (T13)
// follow rowmax_dot; each says there what it replaces and what bounds it.

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

// ---- T9, T10: rows in blocks of `win`, the last block partial ----
//
// y[b, r] = (r < H ? x[b, r] : 0) * scale + shift for r < out_rows, x fp32
// [B, H, row] (row = W C). Replaces tools/probe_nondiv_blocks.py's
// probe_nondiv_read_write (T9: out_rows = ceil(H / win) win, scale 1, shift
// 1; its Pallas kernel masks the rows past H to 0 and adds 1) and
// probe_nondiv_out_exact (T10: out_rows = H, scale 2, shift 0). Both run on
// the Pallas grid (image, block of win rows), so with H 32 and win 14 the
// third block holds 4 real rows. The TPU probes ask what the partial
// block's out-of-bounds reads contain (Q2) and whether its out-of-bounds
// writes are dropped (Q3). On the card either access would be undefined
// behaviour, so both are guards on the address: a row past H is never read
// (T9's pad rows are 0 * 1 + 1 = 1.0, as on the TPU) and a row past
// out_rows is never written (T10's rows past H stay as they were).
//
// What bounds it: bytes, 4.85 MB (T9) and 4.19 MB (T10) at the tool's
// shapes, 1.3-1.5 us at the HBM peak; one launch of some 50 blocks is
// bound by its latency first. Each block takes one float4 column strip of
// a row for every row of its row block; the multiply and add are rounded
// apart (no fma), as the plain version's two operations are.
constexpr int AFFINE_THREADS = 128;
constexpr int AFFINE_COLS = AFFINE_THREADS * 4;  // floats of a row a block covers

__global__ void __launch_bounds__(AFFINE_THREADS)
row_block_affine_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int out_rows,
                        int row, int64_t y_batch, int win, float scale, float shift) {
  const int b = blockIdx.z, r0 = blockIdx.y * win;
  const int c = blockIdx.x * AFFINE_COLS + threadIdx.x * 4;
  if (c >= row) return;
  const float* xb = x + (int64_t)b * H * row + c;
  float* yb = y + (int64_t)b * y_batch + c;
  for (int r = r0; r < r0 + win; ++r) {
    if (r >= out_rows) break;  // the partial block's rows past the output: never written
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < H) v = *reinterpret_cast<const float4*>(xb + (int64_t)r * row);  // never read past H
    v.x = __fadd_rn(__fmul_rn(v.x, scale), shift);
    v.y = __fadd_rn(__fmul_rn(v.y, scale), shift);
    v.z = __fadd_rn(__fmul_rn(v.z, scale), shift);
    v.w = __fadd_rn(__fmul_rn(v.w, scale), shift);
    *reinterpret_cast<float4*>(yb + (int64_t)r * row) = v;
  }
}

// ---- T11, T12: sums over the window columns of a row ----
//
// out[b, r, j, c] = sum over t < win with j win + t < W of x[b, r, j win +
// t, c], x fp32 [B, R, W, C] -> [B, R, nJ, C], nJ = ceil(W / win).
// Replaces tools/probe_nondiv_blocks.py's probe_inkernel_pad_loop (T11: the
// block padded to nJ win columns inside the kernel, a fori_loop over j of
// pl.ds slices) and probe_oversized_sublane_block (T12: a 48-column block
// over the 32-column array, unaligned starts j win, the columns past W
// masked). The Pallas block (1, 14, 32, 256) fp32 is 458 KB, twice what a
// block's shared memory holds, so here a block takes one (image, row) and
// SUM_COLS channels. STAGED (T11) copies that slice into shared memory
// zero-padded to nJ win columns and loops over j there; masked (T12) reads
// global memory through the column mask and never touches a column past W.
// Both add the win terms of a sum in one order, pad terms as 0.0, so T12 is
// bit-equal to T11.
//
// What bounds it: bytes, 1.0 MB at the tool's shapes (0.30 us); 112 blocks
// of one short loop each are bound by the launch.
constexpr int SUM_THREADS = 128;
constexpr int SUM_COLS = 64;  // channels a block covers
constexpr int SUM_MAX_SHARED = 48 * 1024;

template <bool STAGED>
__global__ void __launch_bounds__(SUM_THREADS)
window_colsum_kernel(const float* __restrict__ x, float* __restrict__ out, int W, int C, int win,
                     int nJ) {
  extern __shared__ float strip[];  // STAGED: [nJ win][SUM_COLS], zero from column W on
  const int c0 = blockIdx.x * SUM_COLS;
  const float* xr = x + (int64_t)blockIdx.y * W * C + c0;  // row (b, r) of x
  float* o = out + (int64_t)blockIdx.y * nJ * C + c0;
  if constexpr (STAGED) {
    for (int e = threadIdx.x; e < nJ * win * SUM_COLS; e += SUM_THREADS) {
      const int w = e / SUM_COLS, c = e % SUM_COLS;
      strip[e] = (w < W && c0 + c < C) ? xr[(int64_t)w * C + c] : 0.f;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nJ * SUM_COLS; e += SUM_THREADS) {
    const int j = e / SUM_COLS, c = e % SUM_COLS;
    if (c0 + c >= C) continue;
    float s = 0.f;
    for (int t = 0; t < win; ++t) {
      const int w = j * win + t;
      float v;
      if constexpr (STAGED)
        v = strip[w * SUM_COLS + c];
      else
        v = w < W ? xr[(int64_t)w * C + c] : 0.f;
      s = __fadd_rn(s, v);
    }
    o[(int64_t)j * C + c] = s;
  }
}

// ---- T13: a batched product a[h] . b[h]^T ----
//
// out[h] = bf16(a[h] . b[h]^T), a and b bf16 [heads, N, D = 64], fp32
// accumulation. Replaces tools/repro_aot_crash.py's pallas_call, whose two
// bodies compute it as a Python loop of 2-D dots over the heads
// (looped_kernel) and as one dot_general with the head as its batch
// dimension (batched_kernel, which crashed the TPU's compile helper). Here
// both are launch shapes of one tile routine: `looped` launches one block
// per 64 x 64 output tile and walks the heads inside it (16 blocks at the
// tool's [12, 256, 64]), batched adds the head as a grid dimension (192
// blocks on the card's 132 SMs). Each tile: the two 64-row operand tiles
// through shared memory (load_rows, zero past N), 4 warps of 16 rows, wmma
// 16 x 16 x 16 (bf16 in, fp32 accumulate) over D in one order, each 16 x 16
// result through the warp's staging tile to bf16 (round to nearest even),
// stores guarded at N; so the two shapes are bit-equal.
//
// What bounds it: bytes, 2.36 MB against 0.10 GFLOP at the tool's shapes
// (0.70 us at the HBM peak, 0.10 us at the bf16 tensor-core peak).
__device__ __forceinline__ void nt_tile(const Operand& a, const Operand& b, bf16* __restrict__ out,
                                        int h, int q0, int k0, int N, bf16 (*As)[LDT],
                                        bf16 (*Bs)[LDT], float (*stage)[16][16], int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int r = lane & 15, half = lane >> 4;
  load_rows(As, a, h, q0, N, tid);
  load_rows(Bs, b, h, k0, N, tid);
  __syncthreads();
  const int n = q0 + warp * 16 + r;
#pragma unroll
  for (int t = 0; t < BKV / 16; ++t) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int d = 0; d < D; d += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, &As[warp * 16][d], LDT);
      wmma::load_matrix_sync(fb, &Bs[t * 16][d], LDT);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(&stage[warp][0][0], acc, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int m = k0 + t * 16 + half * 8 + c;
      if (n < N && m < N)
        out[((int64_t)h * N + n) * N + m] = __float2bfloat16_rn(stage[warp][r][half * 8 + c]);
    }
    __syncwarp();
  }
  __syncthreads();  // both tiles consumed before the next head's loads
}

__global__ void __launch_bounds__(THREADS)
batched_nt_kernel(Operand a, Operand b, bf16* __restrict__ out, int heads, int N, int looped) {
  __shared__ __align__(128) bf16 As[BQ][LDT];
  __shared__ __align__(128) bf16 Bs[BKV][LDT];
  __shared__ __align__(128) float stage[WARPS][16][16];
  const int q0 = blockIdx.x * BQ, k0 = blockIdx.y * BKV;
  const int h_end = looped ? heads : blockIdx.z + 1;
  for (int h = looped ? 0 : blockIdx.z; h < h_end; ++h)
    nt_tile(a, b, out, h, q0, k0, N, As, Bs, stage, threadIdx.x);
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

// y = (row r of x if r < H, else 0) * scale + shift for rows r < out_rows
// of each image, x fp32 [B, H, row] contiguous, y fp32 [B, out_rows, row]
// with images y_batch elements apart (>= out_rows row; a view of a larger
// buffer leaves the rows between untouched), in blocks of win rows; row and
// y_batch multiples of 4 (16-byte accesses).
int samroad_row_block_affine(const void* x, void* y, int B, int H, int out_rows, int row,
                             int y_batch, int win, float scale, float shift, void* stream) {
  if (B <= 0 || H <= 0 || out_rows <= 0 || row <= 0 || win <= 0 || row % 4 || y_batch % 4 ||
      (int64_t)y_batch < (int64_t)out_rows * row || B > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((row + AFFINE_COLS - 1) / AFFINE_COLS, (out_rows + win - 1) / win, B);
  row_block_affine_kernel<<<grid, AFFINE_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(x), reinterpret_cast<float*>(y), H, out_rows, row, y_batch,
      win, scale, shift);
  return (int)cudaGetLastError();
}

// out [B, R, nJ, C] fp32 = the sums of each row's W columns in windows of
// win, nJ = ceil(W / win), x fp32 [B, R, W, C] contiguous; staged != 0
// through a zero-padded shared-memory strip (T11), else masked global reads
// (T12).
int samroad_window_colsum(const void* x, void* out, int B, int R, int W, int C, int win,
                          int staged, void* stream) {
  if (B <= 0 || R <= 0 || W <= 0 || C <= 0 || win <= 0 || (int64_t)B * R > 65535)
    return (int)cudaErrorInvalidValue;
  const int nJ = (W + win - 1) / win;
  const size_t shared = staged ? (size_t)nJ * win * SUM_COLS * sizeof(float) : 0;
  if (shared > SUM_MAX_SHARED) return (int)cudaErrorInvalidValue;
  dim3 grid((C + SUM_COLS - 1) / SUM_COLS, B * R);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = reinterpret_cast<const float*>(x);
  float* of = reinterpret_cast<float*>(out);
  if (staged)
    window_colsum_kernel<true><<<grid, SUM_THREADS, shared, s>>>(xf, of, W, C, win, nJ);
  else
    window_colsum_kernel<false><<<grid, SUM_THREADS, 0, s>>>(xf, of, W, C, win, nJ);
  return (int)cudaGetLastError();
}

// out [heads, N, N] bf16 = a[h] . b[h]^T, a and b bf16 [heads, N, depth]
// contiguous, depth 64; looped != 0: one block per 64 x 64 output tile that
// walks the heads, else one block per (tile, head).
int samroad_batched_nt(const void* a, const void* b, void* out, int heads, int N, int depth,
                       int looped, void* stream) {
  if (heads <= 0 || N <= 0 || depth != D || (!looped && heads > 65535))
    return (int)cudaErrorInvalidValue;
  const Operand oa{reinterpret_cast<const bf16*>(a), D, (int64_t)N * D, 0};
  const Operand ob{reinterpret_cast<const bf16*>(b), D, (int64_t)N * D, 0};
  dim3 grid((N + BQ - 1) / BQ, (N + BKV - 1) / BKV, looped ? 1 : heads);
  batched_nt_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      oa, ob, reinterpret_cast<bf16*>(out), heads, N, looped);
  return (int)cudaGetLastError();
}

}  // extern "C"
