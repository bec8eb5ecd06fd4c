// Causal, optionally sliding-window, flash attention for Hopper, sm_90a,
// with both products on the tensor cores as three-term TF32 ("3xTF32"):
//
//   o[b, s, h, :] = sum_t softmax_t(mask(q[b,s,h,:] . k[b,t,h/g,:] / sqrt(D)))
//                   * v[b, t, h/g, :]
//
// q, o [B, S, Hq, D] and k, v [B, S, Hkv, D], f32 or bf16, contiguous and
// 16-byte aligned, read and written in place (no transposes, no repeat of the
// KV heads: query head h reads KV head h / (Hq / Hkv)).  The mask keeps
// t <= s and, with window > 0, t > s - window.  The output is rounded to the
// input dtype once, at the store.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/flash_attn.py:78, pallas_call at :96,
// body _kernel :30-75) and the GQA repeat and [B,S,H,D] <-> [B,H,S,D]
// moves of its wrapper (flash_attn/ops.py:23-31), for the inputs the
// tensor-core bf16 kernel (flash_attn_wgmma.cu) does not take: f32 at every
// head dim, bf16 at head dims 16 and 32.
//
// What bounds it: operations.  At gemma3-12b's prefill (S = 4096, D = 256)
// each (query, key) pair kept costs 4*D flops against q, k, v and o moved
// once: some 1,400 flops a byte.  On the CUDA cores (67 TFLOP/s f32) that
// is a 4.1 ms floor; f32 on the tensor cores goes through TF32 (495
// TFLOP/s), whose 10-bit mantissa alone misses the f32 tolerance by
// 35-100x.  So every f32 operand x is split into big = tf32(x) and small =
// tf32(x - big) (as cvt.rna: round to nearest, ties away), and each product
// a.b is taken as small(a).big(b) + big(a).small(b) + big(a).big(b) in an
// f32 accumulator (CUTLASS's "3xTF32"): the dropped small.small term is
// 2^-22 of the product, the f32 result's own rounding is 2^-24.  Three
// products at the TF32 rate bound the kernel at 495/3 TFLOP/s.  A bf16
// value is exact in TF32 (its small part is 0): Q.K^T takes one product,
// P.V two (P is f32).
//
// What the design does about it:
// * Blocks of 128 query rows against 32-key tiles.  Each warp owns 16
//   query rows (mma m16n8k8's M) at D = 256 (8 warps, one block an SM: the
//   16 x 256 output accumulator takes 128 registers a thread) and 32 rows,
//   two m16 tiles, below it (4 warps, two blocks an SM), where every K
//   and V fragment a warp splits feeds both tiles: the split's integer and
//   float work, not the products, is most of the instructions.  The
//   online-softmax state (running max m, sum l) of a row lives in the
//   four lanes of one quad, the output accumulator in the warp's
//   registers.  A warp skips a key tile none of its rows keeps.
// * A block walks only the key tiles the causal band needs (the TPU
//   kernel's block skip, flash_attn.py:37-42), on both sides of the band
//   when there is a window; the blocks of the last (heaviest) query tiles
//   are scheduled first.
// * Q, K and V tiles are staged in shared memory in the input dtype by
//   cp.async (16 B, .cg), K and V in separate tiles so the copies overlap
//   the products: V of tile j lands while S = Q.K_j^T is computed, K of
//   tile j+1 while O += P.V_j runs.  Rows past S arrive as zeros.
// * Q and K fragments are read by ldmatrix (each f32 is two b16 halves:
//   thread (g, t) gets word t of row g, the TF32 A/B fragment layout);
//   rows are padded by 16 bytes, which makes every 8-row read hit 8
//   different 16-byte bank groups.  Every operand value is split into
//   its two TF32 parts in registers as it is read.
// * P never leaves registers.  The reduction over keys may take the keys
//   of an 8-key step in any order as long as P and V agree, so the A
//   fragment's k-slots t and t+4 are assigned keys 2t and 2t+1: exactly
//   the two columns the S accumulator already holds in that thread, so P
//   goes from the C fragment to the A fragment with no shuffle and no
//   shared memory.  V's B fragment follows: rows 2t and 2t+1.  The output
//   columns of two 8-column n-tiles are interleaved (n-th column of the
//   first at 2n, of the second at 2n+1), so a thread reads V two adjacent
//   columns at a time, conflict-free with the 16-byte pad, and stores
//   four adjacent output columns at once.
// * A row whose keys in a tile are all masked (a window that starts inside
//   the tile, or rows past S) adds nothing: its max stays -inf and its
//   probabilities are 0, whatever order the tiles come in.  The reference's
//   -1e30 trick relies on a later real score to rescale such garbage away;
//   here there is none to rescale.
// * Ragged S: rows and keys past S are loaded as 0, keys past S are
//   masked, rows past S are not stored.
//
// Built with -DREPRO_PIPELINE_CHECK (the checked library of build.py) it
// logs its cp.async pipeline on lane 0 of each warp (pipeline_check.cuh):
// each tile load with its buffer, each commit and wait_group, each
// __syncthreads by its site, and each read of a Q, K or V tile with the
// tile it expects.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pipeline_check.cuh"

namespace {

constexpr int kBQ = 128;        // query rows a block
constexpr int kBK = 32;         // keys a tile
constexpr int kWideD = 256;     // head dims from which a warp takes 16 rows
constexpr int kBlocksPerSM = 2; // resident on an SM below kWideD
constexpr int kBadArgs = 1000;  // returned for arguments refused
constexpr float kLog2e = 1.4426950408889634f;

// A warp owns 16 * kMT query rows: two m16 tiles below kWideD, where each
// K and V fragment it splits then feeds both; one at D = 256, where the
// output accumulator of 16 rows already takes 128 registers a thread.
template <int D>
struct Tile {
  static constexpr bool kWide = D >= kWideD;
  static constexpr int kMT = kWide ? 1 : 2;             // m16 tiles a warp
  static constexpr int kWarps = kBQ / (16 * kMT);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = kWide ? 1 : kBlocksPerSM;
};

// shared-memory rows of D elements of T, padded by 16 bytes
template <typename T, int D>
struct Smem {
  static constexpr int kStride = D + 16 / (int)sizeof(T);  // elements
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(kBQ + 2 * kBK) * kStride;
};

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// cvt.rna.tf32.f32 of a finite x: round to the nearest value with a 10-bit
// mantissa, ties away from zero (add half a TF32 unit to the bit pattern,
// clear the 13 bits below it).  Written as its two integer steps: the PTX
// instruction compiles to more SASS instructions on sm_90a (it also checks
// for NaN), and the split rounds every operand value twice.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 2^x on the special-function unit (ex2.approx, which exp2f is built on;
// results below 2^-126, which no sum here can tell from 0, flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a . b, m16n8k8, TF32 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- fragments ------------------------------------------------------------
//
// m16n8k8 TF32 (PTX ISA, "matrix fragments for mma.m16n8k8"), g = lane / 4,
// t = lane % 4:
//   A 16 x 8:  a0 (g, t)    a1 (g+8, t)    a2 (g, t+4)    a3 (g+8, t+4)
//   B 8 x 8:   b0 (k t, n g)               b1 (k t+4, n g)
//   C 16 x 8:  c0 (g, 2t)   c1 (g, 2t+1)   c2 (g+8, 2t)   c3 (g+8, 2t+1)
//
// Operands are kept as a big and a small TF32 part.  f32: big = tf32(x),
// small = tf32(x - big); bf16: x itself, exact in TF32, and no small part.

template <typename T>
struct Split;

template <>
struct Split<float> {
  static constexpr bool kSmall = true;
  template <int N>
  __device__ __forceinline__ static void of(const float (&x)[N],
                                            uint32_t (&big)[N],
                                            uint32_t (&small)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      big[i] = to_tf32(x[i]);
      small[i] = to_tf32(x[i] - __uint_as_float(big[i]));
    }
  }
};

template <>
struct Split<__nv_bfloat16> {
  static constexpr bool kSmall = false;
  template <int N>
  __device__ __forceinline__ static void of(const float (&x)[N],
                                            uint32_t (&big)[N],
                                            uint32_t (&)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) big[i] = __float_as_uint(x[i]);
  }
};

__device__ __forceinline__ float bf_lo(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// Each lane's shared-memory byte offset for the fragment loads below, from
// the first row and column of the tile.  In bf16 a k-step's eight columns
// are one 16-byte row of an 8 x 8 b16 matrix: thread (g, t) gets columns
// 2t and 2t+1, which stand for the k-slots t and t+4 in both Q and K.
template <typename T, int STRIDE>
__device__ __forceinline__ uint32_t a_lane(int lane) {  // Q: rows, k-cols
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = sizeof(T) == 4 ? ((lane >> 4) & 1) * 4 : 0;
  return (uint32_t)((row * STRIDE + col) * sizeof(T));
}

template <typename T, int STRIDE>
__device__ __forceinline__ uint32_t kb_lane(int lane) {  // K: keys, k-cols
  const int key = sizeof(T) == 4 ? (lane & 7) + ((lane >> 4) & 1) * 8
                                 : (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = sizeof(T) == 4 ? ((lane >> 3) & 1) * 4 : 0;
  return (uint32_t)((key * STRIDE + col) * sizeof(T));
}

// V: rows 2t and 2t + 1 of a key step (see load_bv), columns 2g and 2g + 1
template <typename T, int STRIDE>
__device__ __forceinline__ uint32_t vb_lane(int lane) {  // V: keys, d-cols
  return (uint32_t)((2 * (lane & 3) * STRIDE + 2 * (lane >> 2)) * sizeof(T));
}

// A fragment of 16 Q rows (one m16 tile) at k-step column kc
template <typename T, int STRIDE>
__device__ __forceinline__ void load_a(uint32_t at, int kc, float (&a)[4]) {
  if constexpr (sizeof(T) == 4) {
    uint32_t r[4];
    ldsm_x4(at + kc * 4, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = __uint_as_float(r[i]);
  } else {
    uint32_t r[2];
    ldsm_x2(at + kc * 2, r);
    a[0] = bf_lo(r[0]);
    a[2] = bf_hi(r[0]);
    a[1] = bf_lo(r[1]);
    a[3] = bf_hi(r[1]);
  }
}

// B fragments of keys n0..n0+7 (b[0..1]) and n0+8..n0+15 (b[2..3]) at
// k-step kc
template <typename T, int STRIDE>
__device__ __forceinline__ void load_bk(uint32_t at, int n0, int kc,
                                        float (&b)[4]) {
  const uint32_t off = (uint32_t)((n0 * STRIDE + kc) * sizeof(T));
  if constexpr (sizeof(T) == 4) {
    uint32_t r[4];
    ldsm_x4(at + off, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = __uint_as_float(r[i]);
  } else {
    uint32_t r[2];
    ldsm_x2(at + off, r);
    b[0] = bf_lo(r[0]);
    b[1] = bf_hi(r[0]);
    b[2] = bf_lo(r[1]);
    b[3] = bf_hi(r[1]);
  }
}

// B fragments of V for the keys j0..j0+7 (k-slot t = key 2t, slot t+4 =
// key 2t+1) and 16 columns from dc, two 8-column n-tiles interleaved: n of
// the first tile is column dc + 2n, of the second dc + 2n + 1, so a
// thread's two columns are adjacent (one 8- or 4-byte load a row) and its
// accumulators hold four adjacent output columns (one store).
// b[0..1]: first tile, b[2..3]: second.
template <typename T, int STRIDE>
__device__ __forceinline__ void load_bv(const T* vs, uint32_t at, int j0,
                                        int dc, float (&b)[4]) {
  const T* p = reinterpret_cast<const T*>(
      reinterpret_cast<const char*>(vs) + at) + j0 * STRIDE + dc;
  if constexpr (sizeof(T) == 4) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    const float2 y = *reinterpret_cast<const float2*>(p + STRIDE);
    b[0] = x.x;
    b[1] = y.x;
    b[2] = x.y;
    b[3] = y.y;
  } else {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t y = *reinterpret_cast<const uint32_t*>(p + STRIDE);
    b[0] = bf_lo(x);
    b[1] = bf_lo(y);
    b[2] = bf_hi(x);
    b[3] = bf_hi(y);
  }
}

// d += a . b over the parts that are not 0: small(a).big(b) +
// big(a).small(b) + big(a).big(b) (three-term TF32), or one term for a
// pair of exact operands
template <bool A_SMALL, bool B_SMALL>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  if constexpr (A_SMALL) mma(d, as, bb);
  if constexpr (B_SMALL) mma(d, ab, bs);
  mma(d, ab, bb);
}

// a [ROWS, D] tile of a [B, S, H, D] tensor into shared memory by cp.async,
// rows past S as 0.  `base` points at (b, 0, h, 0) and is 16-byte aligned
// (the wrapper checks the tensors; D and H * D are multiples of 8); `row`
// is H * D.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* base, int64_t row,
                                          int start, int s_len) {
  constexpr int kStride = Smem<T, D>::kStride;
  constexpr int kN = 16 / sizeof(T);      // elements a copy
  constexpr int kPerRow = D / kN;
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += THREADS) {
    const int r = c / kPerRow, x = (c % kPerRow) * kN;
    const int s = start + r;
    const bool valid = s < s_len;
    cp_async16(smem_addr(dst + r * kStride + x),
               base + (int64_t)(valid ? s : 0) * row + x, valid);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, Tile<D>::kMinBlocks)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int s_len,
                      int hq, int hkv, int window, float scale_log2) {
  using Tl = Tile<D>;
  using Sp = Split<T>;
  constexpr int kS = Smem<T, D>::kStride;
  constexpr int kMT = Tl::kMT;
  constexpr int kNT = kBK / 8;  // 8-key column tiles of S
  constexpr int kDT = D / 8;    // 8-column tiles of O; k-steps of Q.K^T
  constexpr int kWR = 16 * kMT;  // rows a warp
  constexpr bool kSmall = Sp::kSmall;
  extern __shared__ float4 smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * kS;
  T* vs = ks + kBK * kS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int hk = h / (hq / hkv);
  const int q_start = qi * kBQ;
  const int q_last = min(q_start + kBQ, s_len) - 1;
  const int r0 = q_start + kWR * warp;  // the warp's first row

  const int64_t q_row = (int64_t)hq * D;  // stride of s in q and o
  const int64_t kv_row = (int64_t)hkv * D;
  const T* qb = q + ((int64_t)b * s_len * hq + h) * D;
  const T* kb = k + ((int64_t)b * s_len * hkv + hk) * D;
  const T* vb = v + ((int64_t)b * s_len * hkv + hk) * D;
  T* ob = o + ((int64_t)b * s_len * hq + h) * D;

  // the key tiles the band needs: from the tile of the first row's first
  // key in the window to the tile of the last row's diagonal
  int kt_lo = 0;
  if (window > 0) {
    const int first = q_start - window + 1;
    kt_lo = first > 0 ? first / kBK : 0;
  }
  const int kt_hi = q_last / kBK;

  if (threadIdx.x == 0)
    PC_LOG(kLayout, smem_addr(qs), smem_addr(ks), smem_addr(vs), -1, 0);
  PC_LANE0_LOG(kLoad, smem_addr(qs), -1, -1, 0, qi);
  load_tile<T, D, kBQ, Tl::kThreads>(qs, qb, q_row, q_start, s_len);
  PC_LANE0_LOG(kLoad, smem_addr(ks), -1, -1, 0, kt_lo);
  load_tile<T, D, kBK, Tl::kThreads>(ks, kb, kv_row, kt_lo * kBK, s_len);
  cp_async_commit();
  PC_LANE0_LOG(kCommit, -1, -1, -1, 0, -1);

  const uint32_t a_at = smem_addr(qs + kWR * warp * kS) + a_lane<T, kS>(lane);
  const uint32_t k_at = smem_addr(ks) + kb_lane<T, kS>(lane);
  const uint32_t v_at = vb_lane<T, kS>(lane);
  constexpr uint32_t kMtBytes = 16 * kS * sizeof(T);  // one m16 tile of Q

  float acc[kMT][kDT][4], m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;  // this thread's share of the row sum
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k_start = kt * kBK;
    const int k_end = k_start + kBK;  // one past the tile's last key
    PC_LANE0_LOG(kLoad, smem_addr(vs), -1, -1, 0, kt);
    load_tile<T, D, kBK, Tl::kThreads>(vs, vb, kv_row, k_start, s_len);
    cp_async_commit();
    PC_LANE0_LOG(kCommit, -1, -1, -1, 0, kt);
    // does any row of this warp keep a key of the tile, and must the tile
    // be masked key by key for it
    const bool active = r0 < s_len && k_start <= r0 + kWR - 1 &&
                        (window == 0 || k_end - 1 > r0 - window);
    const bool full = k_end - 1 <= r0 && k_end <= s_len &&
                      (window == 0 || k_start > r0 + kWR - 1 - window);
    cp_async_wait<1>();  // this tile's K (and Q) have landed
    PC_LANE0_LOG(kWaitGroup, -1, -1, 1, 0, kt);
    __syncthreads();
    PC_LANE0_LOG(kSync, -1, -1, 1, 0, kt);

    // ---- S = Q K^T for the warp's rows (V is in flight)
    float sc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][n][e] = 0.f;
    if (active) {
      PC_LANE0_LOG(kRead, smem_addr(qs), -1, -1, 0, qi);
      PC_LANE0_LOG(kRead, smem_addr(ks), -1, -1, 0, kt);
#pragma unroll
      for (int kc = 0; kc < D; kc += 8) {
        uint32_t ab[kMT][4], as[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          float a[4];
          load_a<T, kS>(a_at + mt * kMtBytes, kc, a);
          Sp::of(a, ab[mt], as[mt]);
        }
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          float bk[4];
          uint32_t bb[4], bs[4];
          load_bk<T, kS>(k_at, 8 * n, kc, bk);
          Sp::of(bk, bb, bs);
          const uint32_t b0b[2] = {bb[0], bb[1]}, b0s[2] = {bs[0], bs[1]};
          const uint32_t b1b[2] = {bb[2], bb[3]}, b1s[2] = {bs[2], bs[3]};
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma3<kSmall, kSmall>(sc[mt][n], ab[mt], as[mt], b0b, b0s);
            mma3<kSmall, kSmall>(sc[mt][n + 1], ab[mt], as[mt], b1b, b1s);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with K
    PC_LANE0_LOG(kSync, -1, -1, 2, 0, kt);
    if (kt < kt_hi) {
      PC_LANE0_LOG(kLoad, smem_addr(ks), -1, -1, 0, kt + 1);
      load_tile<T, D, kBK, Tl::kThreads>(ks, kb, kv_row, k_end, s_len);
      cp_async_commit();
      PC_LANE0_LOG(kCommit, -1, -1, -1, 0, kt + 1);
    }

    // ---- mask, then the online softmax of rows g and g + 8 of each m16
    // tile, in base 2: m is the running max of the scores times
    // scale * log2(e)
    if (active) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!full) {
              const int kpos = k_start + 8 * n + 2 * t + (e & 1);
              const int qpos = r0 + 16 * mt + g + 8 * (e >> 1);
              const bool keep = kpos <= qpos && kpos < s_len &&
                                (window == 0 || kpos > qpos - window);
              sc[mt][n][e] = keep ? sc[mt][n][e] : -INFINITY;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[mt][n][e]);
          }
        float alpha[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[mt][r], mx[r] * scale_log2);
          // no key of this row kept so far: nothing to rescale, p = 0
          alpha[r] = m_new == -INFINITY ? 1.f : ex2(m[mt][r] - m_new);
          base[r] = m_new == -INFINITY ? 0.f : m_new;
          m[mt][r] = m_new;
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[mt][n][e] =
                ex2(fmaf(sc[mt][n][e], scale_log2, -base[e >> 1]));
            sum[e >> 1] += sc[mt][n][e];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[r] + sum[r];
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          acc[mt][n][0] *= alpha[0];
          acc[mt][n][1] *= alpha[0];
          acc[mt][n][2] *= alpha[1];
          acc[mt][n][3] *= alpha[1];
        }
      }
    }
    if (kt < kt_hi) {
      cp_async_wait<1>();  // this tile's V has landed; the next K flies
      PC_LANE0_LOG(kWaitGroup, -1, -1, 1, 0, kt);
    } else {
      cp_async_wait<0>();
      PC_LANE0_LOG(kWaitGroup, -1, -1, 0, 0, kt);
    }
    __syncthreads();
    PC_LANE0_LOG(kSync, -1, -1, 3, 0, kt);

    // ---- O += P V over the tile's keys (the next tile's K is in flight)
    if (active) {
      PC_LANE0_LOG(kRead, smem_addr(vs), -1, -1, 0, kt);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        // k-slot t <- key 8j + 2t (c0, c2), slot t + 4 <- key 8j + 2t + 1
        uint32_t pb[kMT][4], ps[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float p[4] = {sc[mt][j][0], sc[mt][j][2], sc[mt][j][1],
                              sc[mt][j][3]};
          Split<float>::of(p, pb[mt], ps[mt]);
        }
#pragma unroll
        for (int n = 0; n < kDT; n += 2) {
          float bv[4];
          uint32_t bb[4], bs[4];
          load_bv<T, kS>(vs, v_at, 8 * j, 8 * n, bv);
          Sp::of(bv, bb, bs);
          const uint32_t b0b[2] = {bb[0], bb[1]}, b0s[2] = {bs[0], bs[1]};
          const uint32_t b1b[2] = {bb[2], bb[3]}, b1s[2] = {bs[2], bs[3]};
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma3<true, kSmall>(acc[mt][n], pb[mt], ps[mt], b0b, b0s);
            mma3<true, kSmall>(acc[mt][n + 1], pb[mt], ps[mt], b1b, b1s);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with V
    PC_LANE0_LOG(kSync, -1, -1, 4, 0, kt);
  }

  // n-tiles n and n + 1 hold, in this thread, the output columns
  // 8n + 4t .. 8n + 4t + 3 as (n, c0), (n + 1, c0), (n, c1), (n + 1, c1)
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
      const int s = r0 + 16 * mt + g + 8 * r;
      if (s >= s_len) continue;
      const float inv = 1.f / fmaxf(l[mt][r], 1e-30f);
      T* orow = ob + s * q_row + 4 * t;
#pragma unroll
      for (int n = 0; n < kDT; n += 2) {
        const float x0 = acc[mt][n][2 * r] * inv;
        const float x1 = acc[mt][n + 1][2 * r] * inv;
        const float x2 = acc[mt][n][2 * r + 1] * inv;
        const float x3 = acc[mt][n + 1][2 * r + 1] * inv;
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(orow + 8 * n) =
              make_float4(x0, x1, x2, x3);
        } else {  // round to nearest even, like astype
          const __nv_bfloat162 lo = __floats2bfloat162_rn(x0, x1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x2, x3);
          *reinterpret_cast<uint2*>(orow + 8 * n) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
        }
      }
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int hq, int hkv, int window, float scale,
           cudaStream_t stream) {
  if constexpr (!PC_BUILT(sizeof(T) == 4 ? PC_F32_DIMS : PC_BF16_DIMS, D)) {
    return kBadArgs;  // a head dim this checked build leaves out
  } else {
    using Tl = Tile<D>;
    const size_t smem = Smem<T, D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // z is scheduled last: every (head, batch) block of the last query
    // tile goes before any block of an earlier one
    const dim3 grid((unsigned)hq, (unsigned)b,
                    (unsigned)((s + kBQ - 1) / kBQ));
    flash_attn_kernel<T, D><<<grid, Tl::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), s, hq, hkv, window,
        scale * kLog2e);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int s, int hq, int hkv, int d, int window, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, s, hq, hkv, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, s, hq, hkv, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, s, hq, hkv, window, scale, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, b, s, hq, hkv, window, scale,
                            stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, s, hq, hkv, window, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, b, s, hq, hkv, window, scale,
                            stream);
    default:
      return kBadArgs;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns 0, a cudaError_t of the launch, or
// 1000 for arguments it refuses (the wrapper checks them first).  The
// checked build also takes the log and its capacity in records a block.
extern "C" int flash_attn_forward(int dtype, const void* q, const void* k,
                                  const void* v, void* o, int b, int s,
                                  int hq, int hkv, int d, int window,
                                  float scale, void* stream PC_ENTRY_PARAMS) {
  if (b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 ||
      window < 0 || b > 65535 || (s + kBQ - 1) / kBQ > 65535) {
    return kBadArgs;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PC_SET_LOG(st);
  if (dtype == 0) {
    return launch_d<float>(q, k, v, o, b, s, hq, hkv, d, window, scale, st);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(q, k, v, o, b, s, hq, hkv, d, window,
                                   scale, st);
  }
  return kBadArgs;
}

// The dynamic shared memory an f32 launch at head dim d asks for
// (Smem<float, d>::kBytes; a bf16 launch asks for half), or -1 for a head
// dim the library is not built for.  The kernel audit holds its budget
// formula to it.
extern "C" long long flash_attn_smem_bytes(int d) {
  switch (d) {
    case 16:
      return (long long)Smem<float, 16>::kBytes;
    case 32:
      return (long long)Smem<float, 32>::kBytes;
    case 64:
      return (long long)Smem<float, 64>::kBytes;
    case 112:
      return (long long)Smem<float, 112>::kBytes;
    case 128:
      return (long long)Smem<float, 128>::kBytes;
    case 256:
      return (long long)Smem<float, 256>::kBytes;
    default:
      return -1;
  }
}

#ifdef REPRO_PIPELINE_CHECK
// bytes of one log record (the host's decoder checks its layout)
extern "C" int pipeline_check_record_bytes() {
  return (int)(pc::kFields * sizeof(int));
}
#endif
