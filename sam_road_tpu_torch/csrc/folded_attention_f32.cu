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
// q~ = [q scale, q.Rh, q.Rw], k~ = [k, onehot(row), onehot(col)], to fp32
// accuracy, with the softmax, its running max and sum in fp32.
//
// What bounds it on the H100: operations, 2 N^2 (D + dv) a (image, head).
// One TF32 product keeps about three decimal digits, which an fp32
// tolerance cannot take, so every product is three TF32 products on the
// tensor cores: each operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), and a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the
// small terms first, into fp32 accumulators (lo_a.lo_b is below fp32's
// rounding). That is fp32-accurate work at 495 / 3 = 165 TFLOP/s, against
// 67 TFLOP/s for fp32 FMAs on the CUDA cores. The product is Hopper's
// warpgroup product, wgmma m64nNk8 on TF32, the only route to that rate
// (mma.sync's TF32 form does not reach it). wgmma reads a TF32 operand
// from shared memory K-major only (no transpose for 32-bit types), and an
// m64n32 product with both operands there reads 3 KB, 24 cycles of the
// SM's 128 bytes a cycle, for 16 cycles of products, so A comes from
// registers where it can. The design:
// - A block is two consumer warpgroups of 64 query rows each and one
//   producer warpgroup, over one (image x head); the blocks lie on the
//   grid's x (any BH). setmaxnreg moves registers from the producer (56 a
//   thread) to the consumers (224). A consumer warpgroup whose 64 rows all
//   lie past N skips the products (a 196-token window computes 256 rows:
//   wgmma's rows come in 64s).
// - q~ is split once, by the consumers: hi stays in registers as each
//   warp's A fragments (D / 2 a thread), lo goes to shared memory in
//   wgmma's no-swizzle K-major layout (8 x 4 core matrices of 128
//   contiguous bytes). So of S = q~.k~^T's three products two take A from
//   registers (hi(q~) . lo(k~), hi(q~) . hi(k~)) and one from shared memory.
// - The producer fills a ring of 32-key k~ / v tiles (three stages, two at
//   D 192) by cp.async, one stage ahead of its split at D 192 and two
//   elsewhere: k~ in 16-byte chunks straight into the core layout, v 4 bytes
//   at a time into a dv x key layout (K-major for p.v), zero-fill past N and
//   past D. Each thread then splits in place the chunks it copied (hi where
//   they landed, lo one tile further on), so it waits for its own copies
//   alone. A stage's full and empty mbarriers pass it between producer and
//   consumers; no block-wide barrier follows the set-up.
// - p stays in registers: the S accumulator of n8 tile j holds keys 8j + 2t
//   and 8j + 2t + 1 of rows g and g + 8 (g = lane / 4, t = lane % 4), so as
//   the A fragment of p.v's k8 step j its slot t is key 8j + 2t and slot
//   t + 4 key 8j + 2t + 1; v is stored in that key order (the sum over keys
//   does not depend on it), and p is split in registers.
// - The online softmax runs on the accumulators: a row lives in the 4
//   lanes of a quad (two shuffles), exponentials by ex2.approx.
// - Keys past N score -inf (their k~ and v rows load as zeros); a 16-key
//   group of the last tile wholly past N is neither copied, split nor
//   multiplied (S takes m64n16 there). Instances (DQK, dv) = (96, 64),
//   (128, 64), (192, 64), (112, 80), (64, 32) (vit_t's windows), a smaller
//   D % 8 == 0 zero-filled. At dv 32, p.v is m64n32k8 and v's split holds
//   32 rows (four 8-row groups) of 32 key slots; the producer's v loop and
//   the output stores take dv / 8 groups as at 64 and 80.
//   Shared memory a block: 168 KB at (96, 64), 208 KB at (128, 64), 224 KB
//   at (192, 64), 200 KB at (112, 80), 104 KB at (64, 32).
// - ptxas -v: 168 registers a thread at launch (384 threads; setmaxnreg then
//   gives the consumers 224), no spill but 16 bytes at (192, 64).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using samroad_mma::cp_async;
using samroad_mma::cp_async_commit;
using samroad_mma::cp_async_wait;
using samroad_mma::ex2;
using samroad_mma::fence_mbar_init;
using samroad_mma::fence_proxy_async;
using samroad_mma::fence_regs;
using samroad_mma::LOG2E;
using samroad_mma::mbar_arrive;
using samroad_mma::mbar_init;
using samroad_mma::mbar_wait;
using samroad_mma::wgmma_commit_and_wait;
using samroad_mma::wgmma_desc;
using samroad_mma::wgmma_fence;

constexpr int BKV = 32;                   // keys a tile: two 16-key groups
constexpr int CWG = 2;                    // consumer warpgroups of 64 query rows a block
constexpr int THREADS = 128 * (CWG + 1);  // and one producer warpgroup
constexpr int SMEM_MAX = 232448;          // a block's dynamic shared memory on Hopper
constexpr uint32_t CORE = 128;            // bytes of a core matrix: the step along K
// setmaxnreg's registers a thread: 56 x 128 + 224 x 256 = 64512 of the SM's 65536
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;

// k~ / v tiles in the ring: three, or two where three would not fit
template <int DQK>
__host__ __device__ constexpr int stages() {
  return DQK > 128 ? 2 : 3;
}
// q~'s lo split (a consumer warpgroup's 64 rows each), the ring's stages
// (k~ and v, each hi where the tile lands and lo beside it), then the
// stages' full and empty mbarriers
template <int DQK, int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (CWG * 64 * DQK + stages<DQK>() * 2 * BKV * (DQK + HD)) * (int)sizeof(float) +
         2 * stages<DQK>() * (int)sizeof(uint64_t);
}

// float index of element (row r, column c) of a K-major tile in wgmma's
// no-swizzle layout, rows of W floats: 8 x 4 core matrices, 128 bytes each,
// consecutive along K, then along rows
template <int W>
__device__ __forceinline__ int core_at(int r, int c) {
  return (((r >> 3) * (W / 4) + (c >> 2)) * 8 + (r & 7)) * 4 + (c & 3);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value: to nearest,
// ties away from zero, on the low 13 bits (half a TF32 ulp added to the
// magnitude, the low bits cleared: two integer instructions, where ptxas
// lowers the cvt with a guard for inf and NaN; nothing split here is either)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 of x, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                   __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

#define F32_F8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x N] += A (descriptor, 64 x 8) . B (descriptor, 8 x N), TF32, both
// K-major, fp32 accumulator (scale-d 1: accumulate)
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss_tf32<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : F32_F8(0)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss_tf32<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, "
      "1, 1;\n}\n"
      : F32_F8(0), F32_F8(8)
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x N] += a (registers, 64 x 8) . B (descriptor, 8 x N), TF32, B
// K-major, fp32 accumulator. The A fragment of warp w's rows 16w.. is
// mma.sync m16n8k8's: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : F32_F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : F32_F8(0), F32_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F32_F8(0), F32_F8(8), F32_F8(16), F32_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_tf32<80>(float (&d)[40], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : F32_F8(0), F32_F8(8), F32_F8(16), F32_F8(24), F32_F8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef F32_F8

// s (keys 0 .. 16G of the tile) += q~ . k~^T over the k8 steps, three
// products a step on one accumulator, the small terms first: lo(q~) (shared
// memory) . hi(k~), then hi(q~) (registers) . lo(k~) and . hi(k~)
template <int DQK, int G>
__device__ __forceinline__ void score_products(float (&s)[BKV / 2],
                                               const uint32_t (&qh)[DQK / 8][4],
                                               const float* Ql, const float* Kh,
                                               const float* Kl) {
  constexpr uint32_t ROW8 = DQK / 4 * CORE;  // bytes between 8-row groups
  float(&sg)[8 * G] = *reinterpret_cast<float(*)[8 * G]>(s);
#pragma unroll
  for (int kk = 0; kk < DQK / 8; ++kk) {  // columns 8kk .. 8kk + 7: core columns 2kk, 2kk + 1
    const uint64_t kh = wgmma_desc(Kh + 64 * kk, CORE, ROW8);
    wgmma_ss_tf32<16 * G>(sg, wgmma_desc(Ql + 64 * kk, CORE, ROW8), kh);
    wgmma_rs_tf32<16 * G>(sg, qh[kk], wgmma_desc(Kl + 64 * kk, CORE, ROW8));
    wgmma_rs_tf32<16 * G>(sg, qh[kk], kh);
  }
}

// o += p . v over the tile's first 16G keys, awaited. k8 step j's A
// fragment is the split of S's n8 tile j (a0 = c0, a1 = c2, a2 = c1,
// a3 = c3); v's split (dv x key slots) holds key 8j + 2t at slot t and
// 8j + 2t + 1 at t + 4
template <int HD, int G>
__device__ __forceinline__ void value_products(float (&o)[HD / 2], const float (&s)[BKV / 2],
                                               const float* Vh, const float* Vl) {
  constexpr uint32_t ROW8 = BKV / 4 * CORE;
  uint32_t ph[2 * G][4], pl[2 * G][4];
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) {
    split(s[4 * j + 0], ph[j][0], pl[j][0]);
    split(s[4 * j + 2], ph[j][1], pl[j][1]);
    split(s[4 * j + 1], ph[j][2], pl[j][2]);
    split(s[4 * j + 3], ph[j][3], pl[j][3]);
  }
  fence_regs(o);
  __syncwarp();
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) {
    const uint64_t vh = wgmma_desc(Vh + 64 * j, CORE, ROW8);
    const uint64_t vl = wgmma_desc(Vl + 64 * j, CORE, ROW8);
    wgmma_rs_tf32<HD>(o, pl[j], vh);
    wgmma_rs_tf32<HD>(o, ph[j], vl);
    wgmma_rs_tf32<HD>(o, ph[j], vh);
  }
  wgmma_commit_and_wait();
  fence_regs(o);
}

template <int DQK, int HD>
__global__ void __launch_bounds__(THREADS, 1)
    folded_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out, int N,
                                int D, int qtiles) {
  static_assert(DQK % 16 == 0 && HD % 8 == 0, "k8 steps of q~, n8 tiles of v");
  constexpr int S = stages<DQK>(), KC4 = DQK / 4;             // 16-byte chunks of a row
  constexpr int QT = 64 * DQK, KT = BKV * DQK, VT = BKV * HD;  // floats of a tile
  constexpr int STAGE = 2 * (KT + VT);
  extern __shared__ __align__(128) float smem[];
  float* Ql = smem;             // [CWG][QT]: lo(q~), core layout
  float* Ring = Ql + CWG * QT;  // [S][k~ hi, lo][KT] [v hi, lo][VT], core layouts
  uint64_t* full = reinterpret_cast<uint64_t*>(Ring + S * STAGE);  // a tile split
  uint64_t* empty = full + S;                                       // a tile consumed
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int64_t bh = blockIdx.x / qtiles;
  const int q0 = (int)(blockIdx.x % qtiles) * 64 * CWG;
  const int ntiles = (N + BKV - 1) / BKV;
  auto groups_of = [&](int j) { return min(BKV / 16, (N - j * BKV + 15) / 16); };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 4);         // each producer warp's arrival
      mbar_init(&empty[st], 4 * CWG);  // each consumer warp's
    }
    fence_mbar_init();
  }
  // q~ split by the consumers: hi of a warp's 16 rows as wgmma A fragments
  // in registers (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
  // of each k8 step), lo into its warpgroup's tile; rows past N, columns
  // past D zeros
  uint32_t qh[DQK / 8][4];
  if (wg < CWG) {
    const int rw = 16 * (warp & 3) + g;  // the thread's first row in the warpgroup's 64
#pragma unroll
    for (int kk = 0; kk < DQK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rw + 8 * (e & 1), c = 8 * kk + t + 4 * (e >> 1), n = q0 + 64 * wg + r;
        const float x = n < N && c < D ? __ldg(q + (bh * N + n) * D + c) : 0.f;
        uint32_t lo;
        split(x, qh[kk][e], lo);
        Ql[wg * QT + core_at<DQK>(r, c)] = __uint_as_float(lo);
      }
    fence_proxy_async();
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  if (wg == CWG) {
    // ---- producer warpgroup: copies tile j into stage j % S once the
    // consumers have released it, S - 1 tiles ahead of its split, and splits
    // it in place (hi where it landed, lo one tile further on); each thread
    // splits the chunks it copied, so it waits for its own copies alone
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int p = tid - 128 * CWG;
    const float* kb = k + bh * N * D;
    const float* vb = v + bh * N * HD;
    // k~'s 16-byte chunks of the core layout; v transposed, the chunk of dv
    // column c and key slots 4 sc .. 4 sc + 3, whose keys are key, key + 2,
    // + 4, + 6 (slot t <-> key 2t, t + 4 <-> 2t + 1 of each 8), 4 bytes at a time
    auto load = [&](int j) {
      const int k0 = j * BKV, groups = groups_of(j);
      float* Kh = Ring + (j % S) * STAGE;
      float* Vh = Kh + 2 * KT;
      for (int e = p; e < 16 * groups * KC4; e += 128) {
        const int r = (e >> 3) / KC4 * 8 + (e & 7), c = (e >> 3) % KC4 * 4;
        const bool ok = k0 + r < N && c < D;
        cp_async<16>(Kh + 4 * e, ok ? kb + (int64_t)(k0 + r) * D + c : kb, ok);
      }
      for (int e = p; e < 4 * groups * HD; e += 128) {
        const int c = e % HD, sc = e / HD, key = k0 + 8 * (sc >> 1) + (sc & 1);
        float* dst = Vh + core_at<BKV>(c, 4 * sc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = key + 2 * i < N;
          cp_async<4>(dst + i, ok ? vb + (int64_t)(key + 2 * i) * HD + c : vb, ok);
        }
      }
    };
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {  // the first stages are free
      if (j < ntiles) load(j);
      cp_async_commit();
    }
    for (int j = 0; j < ntiles; ++j) {
      cp_async_wait<S - 2>();  // tile j's copies (this thread's)
      const int groups = groups_of(j);
      float* Kh = Ring + (j % S) * STAGE;
      for (int e = p; e < 16 * groups * KC4; e += 128) {
        float4 hi, lo;
        split4(reinterpret_cast<const float4*>(Kh)[e], hi, lo);
        reinterpret_cast<float4*>(Kh)[e] = hi;
        reinterpret_cast<float4*>(Kh + KT)[e] = lo;
      }
      for (int e = p; e < 4 * groups * HD; e += 128) {
        float* x = Kh + 2 * KT + core_at<BKV>(e % HD, 4 * (e / HD));
        float4 hi, lo;
        split4(*reinterpret_cast<const float4*>(x), hi, lo);
        *reinterpret_cast<float4*>(x) = hi;
        *reinterpret_cast<float4*>(x + VT) = lo;
      }
      fence_proxy_async();  // the splits, visible to wgmma (the async proxy)
      __syncwarp();         // ... from the whole warp, which arrives once
      if (lane == 0) mbar_arrive(&full[j % S]);
      const int jn = j + S - 1;  // its stage held tile j - 1
      if (jn < ntiles) {
        mbar_wait(&empty[jn % S], ((jn / S) & 1) ^ 1);
        load(jn);
      }
      cp_async_commit();
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each; one whose rows all lie
  // past N only releases the stages
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const bool active = q0 + 64 * wg < N;
  float o[HD / 2];  // n8 tile d at o[4d ..]: rows g (4d, 4d + 1) and g + 8
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % S, k0 = j * BKV, groups = groups_of(j);
    const float* Kh = Ring + st * STAGE;
    const float* Vh = Kh + 2 * KT;
    mbar_wait(&full[st], (j / S) & 1);
    if (active) {
      float s[BKV / 2];  // n8 tile j at s[4j ..]: keys 8j + 2t, + 1 of rows g and g + 8
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      __syncwarp();
      wgmma_fence();
      if (groups == 2)
        score_products<DQK, 2>(s, qh, Ql + wg * QT, Kh, Kh + KT);
      else
        score_products<DQK, 1>(s, qh, Ql + wg * QT, Kh, Kh + KT);
      wgmma_commit_and_wait();
      fence_regs(s);
      // online softmax; key k0 < N is in every tile, so each row's max is finite
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= N) s[i] = -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float mb[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = ex2((m[h] - mx[h]) * LOG2E);  // 0 on the first tile (m = -inf)
        m[h] = mx[h];
        mb[h] = mx[h] * LOG2E;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        s[i] = ex2(fmaf(s[i], LOG2E, -mb[(i >> 1) & 1]));
        l[(i >> 1) & 1] += s[i];
      }
      if (groups == 2)
        value_products<HD, 2>(o, s, Vh, Vh + VT);
      else
        value_products<HD, 1>(o, s, Vh, Vh + VT);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int n = q0 + 16 * warp + g + 8 * h;
    if (n < N) {
      const float f = 1.f / l[h];
      float* dst = out + (bh * N + n) * HD + 2 * t;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<float2*>(dst + 8 * d) =
            make_float2(o[4 * d + 2 * h] * f, o[4 * d + 2 * h + 1] * f);
    }
  }
}

template <int DQK, int HD>
int launch(const float* q, const float* k, const float* v, float* out, int BH, int N, int D,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DQK, HD>();
  static_assert(bytes <= SMEM_MAX, "the block's tiles exceed Hopper's shared memory");
  const int64_t qtiles = (N + 64 * CWG - 1) / (64 * CWG);
  const int64_t blocks = (int64_t)BH * qtiles;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(folded_attention_f32_kernel<DQK, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  folded_attention_f32_kernel<DQK, HD>
      <<<(unsigned)blocks, THREADS, bytes, stream>>>(q, k, v, out, N, D, (int)qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5 in fp32: q~ (scaled), k~ [BH, N, D] and v [BH, N, dv] -> out [BH, N, dv],
// fp32; the bf16 kernel's instance set (dv 64 with D <= 96, 128 or 192, dv 80
// with D <= 112, dv 32 with D <= 64; D % 8 == 0). Any N and BH up to
// 2^31 - 1 blocks.
int samroad_folded_attention_f32(const void* q, const void* k, const void* v, void* out,
                                 int BH, int N, int D, int dv, void* stream) {
  if (BH <= 0 || N <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  const float* qf = reinterpret_cast<const float*>(q);
  const float* kf = reinterpret_cast<const float*>(k);
  const float* vf = reinterpret_cast<const float*>(v);
  float* of = reinterpret_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dv == 64 && D <= 96) return launch<96, 64>(qf, kf, vf, of, BH, N, D, s);
  if (dv == 64 && D <= 128) return launch<128, 64>(qf, kf, vf, of, BH, N, D, s);
  if (dv == 64 && D <= 192) return launch<192, 64>(qf, kf, vf, of, BH, N, D, s);
  if (dv == 80 && D <= 112) return launch<112, 80>(qf, kf, vf, of, BH, N, D, s);
  if (dv == 32 && D <= 64) return launch<64, 32>(qf, kf, vf, of, BH, N, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
