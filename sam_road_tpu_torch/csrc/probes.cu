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
// What bounds it on the H100: the launch and one trip to memory. T7 is 164
// MFLOP against 0.8 MB (0.25 us at the HBM peak, 0.17 us at the bf16
// tensor-core peak), T8 41 MFLOP against the 0.41 MB of its two heads and
// its output (0.12 us). So the design puts every load in flight at once and
// spreads the blocks over the SMs. A block takes one image's RM_Q = 32
// query rows (224 blocks for T7, 56 for T8) and all of the image's keys:
// the query tile and the key tiles of 64 rows arrive by cp.async, each in
// its own commit group, and a ring of RM_STAGES = 4 key tiles holds every
// key at N <= 256, so all of them are issued before the first wait (a
// larger N refills the ring as each tile is consumed). Eight warps: two
// 16-row query strips times four warps that split each key tile 16 keys
// apiece. The scores are mma.sync m16n8k16 products (bf16 operands by
// ldmatrix, fp32 accumulators); each thread takes the max of its
// accumulator registers directly, key columns at or past N masked to -inf
// first (a zero-filled key row scores 0, which would beat a row whose real
// scores are all negative), then across the four lanes of its quad by
// shuffles, then across the four key warps through 512 bytes of shared
// memory. Query rows at or past N are zero-filled and never written.
// 32-row query tiles rather than 16: T7 at 16 rows would be 416 blocks
// that read each image's 25.6 KB of keys 13 times from L2 (10.6 MB) where
// 32 rows read them 7 times (5.7 MB), and 224 blocks of 42 KB of shared
// memory already fill the 132 SMs in one wave.
//
// row_block_affine (T9, T10), window_colsum (T11, T12) and batched_nt (T13)
// follow rowmax_dot; each says there what it replaces and what bounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

using namespace samroad_mma;

namespace {

constexpr int D = 64;           // the contraction depth (a head)
constexpr int MAX_DEVICES = 64;

// ---- T7, T8: rowmax_dot ----
constexpr int RM_Q = 32;        // query rows a block: two 16-row strips
constexpr int RM_K = 64;        // key rows a stage of the ring
constexpr int RM_STAGES = 4;    // the ring: every key in flight at once at N <= 256
constexpr int RM_KWARPS = 4;    // warps that split a stage's keys, 16 each
constexpr int RM_THREADS = RM_Q / 16 * RM_KWARPS * 32;  // 256
constexpr int RM_LD = D + 8;    // 144-byte rows: ldmatrix conflict-free

struct Operand {
  const bf16* p;               // element (0, 0, 0) of the tensor
  int64_t row, batch;          // strides, in elements
  int col;                     // the first of the D columns read
};

struct RowmaxSmem {
  bf16 q[RM_Q][RM_LD];
  bf16 k[RM_STAGES][RM_K][RM_LD];
  float part[RM_Q / 16][RM_KWARPS][16];  // each key warp's max of each query row
};  // 41,984 bytes: static shared memory

// rows [r0, r0 + ROWS) of image b's operand into dst by cp.async, 16 bytes a
// copy; rows from N on are zero-filled and never read
template <int ROWS>
__device__ __forceinline__ void rowmax_load(bf16 (*dst)[RM_LD], const Operand& o, int64_t b,
                                            int r0, int N) {
  for (int e = threadIdx.x; e < ROWS * (D / 8); e += RM_THREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8, n = r0 + r;
    cp_async<16>(&dst[r][c], o.p + b * o.batch + (int64_t)(n < N ? n : 0) * o.row + o.col + c,
                 n < N);
  }
}

__global__ void __launch_bounds__(RM_THREADS)
rowmax_dot_kernel(Operand qa, Operand kb, bf16* __restrict__ out, int N, int tiles) {
  __shared__ __align__(128) RowmaxSmem s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strip = warp / RM_KWARPS, kw = warp % RM_KWARPS;  // query strip, key quarter
  const int g = lane >> 2, tq = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int64_t b = blockIdx.x / tiles;
  const int q0 = blockIdx.x % tiles * RM_Q, stages = (N + RM_K - 1) / RM_K;

  // the query tile and the ring's key tiles, all issued before the first
  // wait; one commit group a stage (the query tile in the first), empty
  // past the last stage, so every wait below counts alike
  rowmax_load<RM_Q>(s.q, qa, b, q0, N);
#pragma unroll
  for (int i = 0; i < RM_STAGES; ++i) {
    if (i < stages) rowmax_load<RM_K>(s.k[i], kb, b, i * RM_K, N);
    cp_async_commit();
  }

  uint32_t fa[D / 16][4];                   // the warp's 16 query rows, all of D
  float mx[2] = {-INFINITY, -INFINITY};     // rows g and g + 8 of the strip
  for (int i = 0; i < stages; ++i) {
    cp_async_wait<RM_STAGES - 1>();
    __syncthreads();  // stage i is in (at i = 0 the query tile too)
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(fa[kk], &s.q[strip * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
    }
    const int buf = i % RM_STAGES;
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t fb[4];  // keys kw 16 + 0..7 (depth kk 16, + 8), then keys + 8..15 (the same)
      ldmatrix_x4(fb, &s.k[buf][kw * 16 + (lm >> 1) * 8 + lr][kk * 16 + (lm & 1) * 8]);
      mma_bf16(acc[0], fa[kk], fb[0], fb[1]);
      mma_bf16(acc[1], fa[kk], fb[2], fb[3]);
    }
    // acc[j][c]: row g + 8 (c / 2), key k0 + 8 j + 2 tq + c % 2; past N -inf
    const int k0 = i * RM_K + kw * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = k0 + 8 * j + 2 * tq + (c & 1) < N ? acc[j][c] : -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], v);
      }
    if (i + RM_STAGES < stages) {  // the ring's next tile into the buffer just read
      __syncthreads();
      rowmax_load<RM_K>(s.k[buf], kb, b, (i + RM_STAGES) * RM_K, N);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {  // the quad's four lanes hold the same two rows
    mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], m));
    mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], m));
  }
  if (tq == 0) {
    s.part[strip][kw][g] = mx[0];
    s.part[strip][kw][g + 8] = mx[1];
  }
  __syncthreads();
  if (threadIdx.x < RM_Q) {  // one thread a query row: the max over the key warps
    const int r = threadIdx.x, n = q0 + r;
    float m = s.part[r / 16][0][r % 16];
#pragma unroll
    for (int w = 1; w < RM_KWARPS; ++w) m = fmaxf(m, s.part[r / 16][w][r % 16]);
    if (n < N) out[b * N + n] = __float2bfloat16_rn(m);
  }
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
// out_rows is never written (T10's rows past H stay as they were). The
// function does not depend on win (the caller's out_rows carries it), so
// the kernel has no row blocks.
//
// What bounds it: bytes, 4.85 MB (T9) and 4.19 MB (T10) at the tool's
// shapes, 1.45 / 1.25 us at the HBM peak. With so little work a launch is
// over after one memory latency or two, so the design is about having every
// load in flight at once: a block takes AFFINE_ROWS rows of one image and
// one float4 of each a thread (336 blocks of 256 threads for T9, 2.5 an
// SM), and a thread issues all its loads before its first store. The
// multiply and add are rounded apart (no fma), as the plain version's two
// operations are.
constexpr int AFFINE_THREADS = 256;
constexpr int AFFINE_ROWS = 2;  // rows a thread carries
constexpr int AFFINE_COLS = AFFINE_THREADS * 4;  // floats of a row a block covers

__global__ void __launch_bounds__(AFFINE_THREADS)
row_block_affine_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int out_rows,
                        int row, int64_t y_batch, float scale, float shift) {
  const int b = blockIdx.z, r0 = blockIdx.y * AFFINE_ROWS;
  const int c = blockIdx.x * AFFINE_COLS + threadIdx.x * 4;
  if (c >= row) return;
  const float* xb = x + (int64_t)b * H * row + c;
  float* yb = y + (int64_t)b * y_batch + c;
  float4 v[AFFINE_ROWS];
#pragma unroll
  for (int i = 0; i < AFFINE_ROWS; ++i) {  // every load first; never a row at or past H
    const int r = r0 + i;
    v[i] = r < H && r < out_rows ? *reinterpret_cast<const float4*>(xb + (int64_t)r * row)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < AFFINE_ROWS; ++i) {  // never a row at or past out_rows
    const int r = r0 + i;
    if (r >= out_rows) break;
    float4 w = v[i];
    w.x = __fadd_rn(__fmul_rn(w.x, scale), shift);
    w.y = __fadd_rn(__fmul_rn(w.y, scale), shift);
    w.z = __fadd_rn(__fmul_rn(w.z, scale), shift);
    w.w = __fadd_rn(__fmul_rn(w.w, scale), shift);
    *reinterpret_cast<float4*>(yb + (int64_t)r * row) = w;
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
// block's shared memory holds, so here a block takes one (image, row) on
// the grid's x (any B R up to 2^31 - 1) and SUM_VECS vectors of channels
// on its y, and a thread one vector of channels of one window column j.
// STAGED (T11) copies the block's slice into shared memory zero-padded to
// nJ win columns by cp.async, columns at or past W zero-filled (the in-kernel
// pad the Pallas probe asks about), waits once, then sums from there; masked
// (T12) reads its terms from global memory through the column mask and
// never touches a column at or past W. Both add the win terms of a sum in
// one order, t = 0 .. win - 1 from 0.0 with __fadd_rn, pad terms as 0.0, so
// T12 is bit-equal to T11.
//
// What bounds it: bytes, 1.0 MB at the tool's shapes (0.30 us at the HBM
// peak); with so little work a launch is over after one memory latency or
// two, so every load is in flight at once. A vector is 4 channels (16-byte
// accesses) where C % 4 == 0, else 1 (the scalar instance). STAGED issues
// every copy of its strip before its one wait; masked holds SUM_TERMS terms
// in registers and issues all of a chunk's loads (predicated, with no branch
// between them) before its first add: at win <= 16 and nJ <= 32 (the tool's
// 14 and 3) that is every load of the thread. The block has SUM_VECS
// threads a window column and nJ of them rounded up to a warp, at most 32:
// 224 blocks of 32 threads at the tool's [2, 14, 32, 256].
constexpr int SUM_VECS = 8;           // vectors of channels a block covers
constexpr int SUM_TERMS = 16;         // terms a thread holds in registers at once
constexpr int SUM_MAX_THREADS = SUM_VECS * 32;
constexpr int SUM_MAX_SHARED = 48 * 1024;

template <int VEC> struct SumVec;  // VEC fp32 channels as one access
template <> struct SumVec<4> {
  typedef float4 T;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                       __fadd_rn(a.w, b.w));
  }
  // *p where valid, else zeros: a predicated load (nothing is read for an
  // invalid term), so no branch keeps a thread's loads apart
  static __device__ __forceinline__ T load_if(const float* p, bool valid) {
    T v;
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
        "mov.f32 %0, 0f00000000;\nmov.f32 %1, 0f00000000;\n"
        "mov.f32 %2, 0f00000000;\nmov.f32 %3, 0f00000000;\n"
        "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n}\n"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p), "r"((int)valid));
    return v;
  }
};
template <> struct SumVec<1> {
  typedef float T;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T load_if(const float* p, bool valid) {
    T v;
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\nmov.f32 %0, 0f00000000;\n"
        "@q ld.global.nc.f32 %0, [%1];\n}\n"
        : "=f"(v)
        : "l"(p), "r"((int)valid));
    return v;
  }
};

// (..., 1): one block an SM is occupancy enough, so ptxas keeps a chunk's
// terms in registers (64 of them as float4s) and issues every load before
// the first add; left to aim at more blocks, it interleaved the loads with
// the adds to save registers, and each add then waited out a load
template <bool STAGED, int VEC>
__global__ void __launch_bounds__(SUM_MAX_THREADS, 1)
window_colsum_kernel(const float* __restrict__ x, float* __restrict__ out, int W, int C, int win,
                     int nJ) {
  typedef SumVec<VEC> S;
  typedef typename S::T V;
  extern __shared__ __align__(16) float strip_[];  // STAGED: [nJ win][SUM_VECS] vectors
  V* strip = reinterpret_cast<V*>(strip_);
  const int c0 = blockIdx.y * SUM_VECS * VEC, v = threadIdx.x % SUM_VECS, c = c0 + v * VEC;
  const float* xr = x + (int64_t)blockIdx.x * W * C;  // row (b, r) of x
  float* o = out + (int64_t)blockIdx.x * nJ * C;
  if constexpr (STAGED) {
    for (int e = threadIdx.x; e < nJ * win * SUM_VECS; e += blockDim.x) {
      const int w = e / SUM_VECS, cc = c0 + e % SUM_VECS * VEC;
      const bool in = w < W && cc < C;  // else zero-filled, nothing read
      cp_async<VEC * 4>(&strip[e], in ? xr + (int64_t)w * C + cc : xr, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const bool live = c < C;  // C % VEC == 0: a vector lies wholly inside or past C
  for (int j = threadIdx.x / SUM_VECS; j < nJ; j += blockDim.x / SUM_VECS) {
    V s = S::zero();
    for (int t0 = 0; t0 < win; t0 += SUM_TERMS) {
      // every load of the chunk first, with no branch between them; terms
      // past win are 0.0, and s + 0.0 is s (s starts at +0.0, so it is never
      // -0.0), so the adds need no branch either
      V term[SUM_TERMS];
#pragma unroll
      for (int i = 0; i < SUM_TERMS; ++i) {
        const int t = t0 + i, w = j * win + t;
        if constexpr (STAGED) {
          const V u = strip[(t < win ? w : j * win) * SUM_VECS + v];
          term[i] = t < win ? u : S::zero();
        } else {
          term[i] = S::load_if(xr + (int64_t)w * C + c, live && t < win && w < W);
        }
      }
#pragma unroll
      for (int i = 0; i < SUM_TERMS; ++i) s = S::add(s, term[i]);  // in order of t
    }
    if (live) *reinterpret_cast<V*>(o + (int64_t)j * C + c) = s;
  }
}

// ---- T13: a batched product a[h] . b[h]^T ----
//
// out[h] = bf16(a[h] . b[h]^T), a and b bf16 [heads, N, D = 64], fp32
// accumulation. Replaces tools/repro_aot_crash.py's pallas_call, whose two
// bodies compute it as a Python loop of 2-D dots over the heads
// (looped_kernel) and as one dot_general with the head as its batch
// dimension (batched_kernel, which crashed the TPU's compile helper). Here
// both are launch shapes of one kernel over the items (head, 64 x 64 output
// tile), each block walking items blockIdx.x, + gridDim.x, ...: `looped` is
// a persistent grid of min(SMs, items) blocks, so one program takes several
// heads' tiles in turn, as looped_kernel unrolls the heads in one program;
// batched is one block per item (192 at the tool's [12, 256, 64]). Both run
// one tile routine with one order of accumulation over D, so they are
// bit-equal.
//
// What bounds it: bytes, 2.36 MB against 0.10 GFLOP at the tool's shapes
// (0.70 us at the HBM peak, 0.10 us at the bf16 tensor-core peak), and
// 1.57 MB of the bytes are the output. At depth 64 an item is 4 k-steps of
// mma.sync m16n8k16 (fp32 accumulators in registers, operands by ldmatrix);
// wgmma's rate would buy nothing against a tenth of a microsecond of math.
// What matters is the memory: the operand tiles arrive by cp.async (rows
// past N zero-filled, never read), a walking block prefetches its next
// item's tiles into the second buffer while it computes the current one,
// and the result is rounded once to bf16 pairs, staged in shared memory
// (rows padded against bank conflicts) and written out a row at a time,
// neighbouring threads on neighbouring addresses, 16 bytes a thread where N
// % 8 == 0 (then 8, 4 or 2 bytes as N allows: output rows start 2N bytes
// apart). No store reaches past [heads, N, N].
constexpr int NT = 64;            // output tile side
constexpr int NT_THREADS = 128;   // 4 warps of 16 tile rows
constexpr int NT_LD = D + 8;      // 144-byte rows: ldmatrix and the stage conflict-free

struct NtSmem {
  bf16 a[2][NT][NT_LD], b[2][NT][NT_LD];  // two buffers of the operand tiles
  bf16 out[NT][NT_LD];                     // the bf16 result tile
};  // 46,080 bytes: static shared memory

template <int VEC> struct NtVec;  // VEC bf16 values as one store
template <> struct NtVec<8> { typedef uint4 T; };
template <> struct NtVec<4> { typedef uint2 T; };
template <> struct NtVec<2> { typedef uint32_t T; };
template <> struct NtVec<1> { typedef unsigned short T; };

// item's operand tiles into buffer buf (one commit group per call)
__device__ __forceinline__ void nt_load(NtSmem& s, int buf, const bf16* __restrict__ a,
                                        const bf16* __restrict__ b, int64_t h, int q0, int k0,
                                        int N) {
  for (int e = threadIdx.x; e < 2 * NT * (D / 8); e += NT_THREADS) {
    const int op = e / (NT * (D / 8)), r = (e / (D / 8)) % NT, c = (e % (D / 8)) * 8;
    const int n = (op ? k0 : q0) + r;
    const bf16* src = (op ? b : a) + (h * N + (n < N ? n : 0)) * D + c;
    cp_async<16>(op ? &s.b[buf][r][c] : &s.a[buf][r][c], src, n < N);
  }
  cp_async_commit();
}

template <int VEC>
__global__ void __launch_bounds__(NT_THREADS)
batched_nt_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, bf16* __restrict__ out,
                  int N, int side, int items) {
  __shared__ __align__(128) NtSmem s;
  typedef typename NtVec<VEC>::T V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int tiles = side * side;
  int item = blockIdx.x;
  if (item < items)
    nt_load(s, 0, a, b, item / tiles, item % tiles / side * NT, item % tiles % side * NT, N);
  for (int buf = 0; item < items; item += gridDim.x, buf ^= 1) {
    const int next = item + gridDim.x;
    if (next < items)  // the walking block's next item, into the other buffer
      nt_load(s, buf ^ 1, a, b, next / tiles, next % tiles / side * NT,
              next % tiles % side * NT, N);
    else
      cp_async_commit();  // an empty group: the wait below counts alike
    cp_async_wait<1>();
    __syncthreads();  // this item's tiles are in

    const int64_t h = item / tiles;
    const int q0 = item % tiles / side * NT, k0 = item % tiles % side * NT;
    float acc[NT / 8][4];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t fa[4];
      ldmatrix_x4(fa, &s.a[buf][warp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < NT / 8; j += 2) {
        uint32_t fb[4];  // keys 8j.. (depth kk*16, +8), then keys 8(j+1).. (the same)
        ldmatrix_x4(fb, &s.b[buf][(j + (lm >> 1)) * 8 + lr][kk * 16 + (lm & 1) * 8]);
        mma_bf16(acc[j], fa, fb[0], fb[1]);
        mma_bf16(acc[j + 1], fa, fb[2], fb[3]);
      }
    }
    // the warp's 16 rows to bf16 pairs in the stage, then out a row at a time
    const int r0 = warp * 16;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      *reinterpret_cast<uint32_t*>(&s.out[r0 + g][j * 8 + 2 * tq]) =
          pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(&s.out[r0 + g + 8][j * 8 + 2 * tq]) =
          pack_bf16(acc[j][2], acc[j][3]);
    }
    __syncwarp();
    constexpr int PER_ROW = NT / VEC;  // stores a tile row
    bf16* o = out + (h * N + q0) * N + k0;
#pragma unroll 4
    for (int e = lane; e < 16 * PER_ROW; e += 32) {
      const int r = r0 + e / PER_ROW, c = (e % PER_ROW) * VEC;
      // N % VEC == 0 and c % VEC == 0: a vector lies wholly inside or past column N
      if (q0 + r < N && k0 + c < N)
        *reinterpret_cast<V*>(o + (int64_t)r * N + c) = *reinterpret_cast<const V*>(&s.out[r][c]);
    }
    __syncthreads();  // buffer buf and the stage are free for the next item
  }
}

}  // namespace

extern "C" {

// out [B, N] bf16 = max over m < N of a[b, n, :] . b[b, m, :], the D = 64
// columns from a_col / b_col on; a and b (which may be one tensor) bf16,
// token rows row_stride elements apart and images batch_stride apart, every
// stride and offset a multiple of 8 (16-byte loads). One block an (image,
// 32-row query tile), all on the grid's x.
int samroad_rowmax_dot(const void* a, const void* b, void* out, int B, int N, int depth,
                       int row_stride, int batch_stride, int a_col, int b_col, void* stream) {
  if (B <= 0 || N <= 0 || depth != D || row_stride % 8 || batch_stride % 8 || a_col % 8 ||
      b_col % 8 || a_col < 0 || b_col < 0 || a_col + D > row_stride || b_col + D > row_stride)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (N + RM_Q - 1) / RM_Q, blocks = B * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const Operand qa{reinterpret_cast<const bf16*>(a), row_stride, batch_stride, a_col};
  const Operand kb{reinterpret_cast<const bf16*>(b), row_stride, batch_stride, b_col};
  rowmax_dot_kernel<<<(int)blocks, RM_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      qa, kb, reinterpret_cast<bf16*>(out), N, (int)tiles);
  return (int)cudaGetLastError();
}

// y = (row r of x if r < H, else 0) * scale + shift for rows r < out_rows
// of each image, x fp32 [B, H, row] contiguous, y fp32 [B, out_rows, row]
// with images y_batch elements apart (>= out_rows row; a view of a larger
// buffer leaves the rows between untouched); row and y_batch multiples of 4
// (16-byte accesses).
int samroad_row_block_affine(const void* x, void* y, int B, int H, int out_rows, int row,
                             int64_t y_batch, float scale, float shift, void* stream) {
  if (B <= 0 || H <= 0 || out_rows <= 0 || row <= 0 || row % 4 || y_batch % 4 ||
      y_batch < (int64_t)out_rows * row || B > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((row + AFFINE_COLS - 1) / AFFINE_COLS, (out_rows + AFFINE_ROWS - 1) / AFFINE_ROWS, B);
  row_block_affine_kernel<<<grid, AFFINE_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(x), reinterpret_cast<float*>(y), H, out_rows, row, y_batch,
      scale, shift);
  return (int)cudaGetLastError();
}

// out [B, R, nJ, C] fp32 = the sums of each row's W columns in windows of
// win, nJ = ceil(W / win), x fp32 [B, R, W, C] contiguous; staged != 0
// through a zero-padded shared-memory strip (T11; refused where the strip,
// nJ win columns of SUM_VECS vectors, would pass 48 KB), else masked global
// reads (T12). Any C: 16-byte accesses where C % 4 == 0, else 4-byte ones.
int samroad_window_colsum(const void* x, void* out, int B, int R, int W, int C, int win,
                          int staged, void* stream) {
  if (B <= 0 || R <= 0 || W <= 0 || C <= 0 || win <= 0 || (int64_t)B * R > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t nJ = ((int64_t)W + win - 1) / win;
  const int vec = C % 4 == 0 ? 4 : 1;
  const int64_t shared = staged ? nJ * win * SUM_VECS * vec * (int64_t)sizeof(float) : 0;
  if (shared > SUM_MAX_SHARED) return (int)cudaErrorInvalidValue;
  // SUM_VECS threads a window column, nJ columns rounded up to a warp, at most 32
  const int64_t lanes = (nJ + 3) / 4 * 4;
  const int threads = SUM_VECS * (int)(lanes < 32 ? lanes : 32);
  dim3 grid(B * R, (C + SUM_VECS * vec - 1) / (SUM_VECS * vec));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = reinterpret_cast<const float*>(x);
  float* of = reinterpret_cast<float*>(out);
  const int J = (int)nJ;
  if (staged && vec == 4)
    window_colsum_kernel<true, 4><<<grid, threads, shared, s>>>(xf, of, W, C, win, J);
  else if (staged)
    window_colsum_kernel<true, 1><<<grid, threads, shared, s>>>(xf, of, W, C, win, J);
  else if (vec == 4)
    window_colsum_kernel<false, 4><<<grid, threads, 0, s>>>(xf, of, W, C, win, J);
  else
    window_colsum_kernel<false, 1><<<grid, threads, 0, s>>>(xf, of, W, C, win, J);
  return (int)cudaGetLastError();
}

// the blocks batched_nt launches for [heads, N, 64]: one per item (head,
// 64 x 64 output tile), or, looped != 0, min(SMs of the current device,
// items) walking the items; the SM count is read once per device
int samroad_batched_nt_grid(int heads, int N, int looped, int* grid) {
  static int sms[MAX_DEVICES] = {};
  if (heads <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int64_t side = (N + NT - 1) / NT, items = heads * side * side;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  *grid = (int)items;
  if (!looped) return 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    const int attr = (int)cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (attr) return attr;
  }
  *grid = (int)(items < sms[dev] ? items : sms[dev]);
  return 0;
}

// out [heads, N, N] bf16 = a[h] . b[h]^T, a and b bf16 [heads, N, depth]
// contiguous, depth 64; the grid as samroad_batched_nt_grid gives it
int samroad_batched_nt(const void* a, const void* b, void* out, int heads, int N, int depth,
                       int looped, void* stream) {
  int grid = 0;
  if (depth != D) return (int)cudaErrorInvalidValue;
  if (const int e = samroad_batched_nt_grid(heads, N, looped, &grid)) return e;
  const int side = (N + NT - 1) / NT, items = heads * side * side;
  const bf16* pa = reinterpret_cast<const bf16*>(a);
  const bf16* pb = reinterpret_cast<const bf16*>(b);
  bf16* po = reinterpret_cast<bf16*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N % 8 == 0)
    batched_nt_kernel<8><<<grid, NT_THREADS, 0, s>>>(pa, pb, po, N, side, items);
  else if (N % 4 == 0)
    batched_nt_kernel<4><<<grid, NT_THREADS, 0, s>>>(pa, pb, po, N, side, items);
  else if (N % 2 == 0)
    batched_nt_kernel<2><<<grid, NT_THREADS, 0, s>>>(pa, pb, po, N, side, items);
  else
    batched_nt_kernel<1><<<grid, NT_THREADS, 0, s>>>(pa, pb, po, N, side, items);
  return (int)cudaGetLastError();
}

}  // extern "C"
