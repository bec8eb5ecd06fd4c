// Causal, optionally sliding-window, flash attention for bf16 on Hopper
// (sm_90a), on the tensor cores:
//
//   o[b, s, h, :] = sum_t softmax_t(mask(q[b,s,h,:] . k[b,t,h/g,:] / sqrt(D)))
//                   * v[b, t, h/g, :]
//
// q, o [B, S, Hq, D] and k, v [B, S, Hkv, D], bf16, contiguous and 16-byte
// aligned, read and written in place (no transposes, no repeat of the KV
// heads: query head h reads KV head h / (Hq / Hkv)).  D is 64, 112, 128 or
// 256; S is any length.  The mask keeps t <= s and, with window > 0,
// t > s - window.  Products accumulate in f32, the softmax runs in f32,
// and the output is rounded to bf16 once, at the store.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/flash_attn.py:78, pallas_call at :96,
// body _kernel :30-75) for bf16 inputs of these head dims; f32 inputs and
// D = 16 or 32 stay on csrc/flash_attn.cu.
//
// What bounds it: operations.  At gemma3-12b's prefill shape (B = 2,
// S = 4096, Hq = 16, Hkv = 8, D = 256) the mask keeps 275.0 GFLOP of
// products at window 0 (4 D flops a kept (query, key) pair): 0.278 ms at
// the 989 TFLOP/s bf16 tensor-core peak, against 0.060 ms for the 201 MB
// of q, k, v and o at 3.35 TB/s.  At window 1024 it is 120.3 GFLOP,
// 0.122 ms.
//
// What the design does about it:
// * Both products run on the tensor cores as wgmma with bf16 operands
//   and f32 accumulators.  S = Q K^T is wgmma.m64n64k16 with Q and K both
//   read from shared memory (both K-major: D is contiguous); O += P V is
//   wgmma.m64nDk16 with P taken from registers (the f32 accumulator
//   fragment of S, rounded to bf16, is the A-operand fragment) and V read
//   from shared memory as an MN-major operand (the transpose bit).
// * One block per (head, batch, 128-query tile), three warpgroups of 128
//   threads: two consumer warpgroups of 64 query rows each, and one
//   producer warpgroup of which one thread issues every load.  setmaxnreg
//   moves registers from the producer (24) to the consumers (240), so
//   the 64 x D f32 output accumulator (128 registers a thread at D = 256)
//   stays in registers beside S and P.
// * The producer loads Q once and then K and V tiles of 64 keys by TMA
//   into a two-stage ring in dynamic shared memory (Q 64 KB and the ring
//   128 KB at D = 256: no room for a third stage or a larger tile).  The
//   tiles are 64 keys at D = 64 and 128 too, so one code path serves the
//   three head dims; D <= 128 has the room for 128-key tiles or a deeper
//   ring, which is left for later.  Each stage has a "full" mbarrier for
//   K and one for V (expected byte counts, so S = Q K^T starts while V is
//   still in flight) and an "empty" mbarrier on which every consumer warp
//   arrives once its wgmma reading the stage has retired.  Tiles are
//   stored with 128-byte swizzling, as 64-column panels (a TMA box is at
//   most 128 bytes wide under that swizzle), which wgmma reads without
//   bank conflicts.
// * The tensor maps are 4-D, (D, H, S, B) with the tensors' own strides,
//   so TMA reads the [B, S, H, D] layout in place, fills rows past S with
//   zeros, and never lets a batch read another's rows.
// * The block walks only the key tiles the causal band needs (the TPU
//   kernel's block skip, flash_attn.py:37-42), on both sides of the band
//   when there is a window, and blocks of the last (heaviest) query tiles
//   are scheduled first.  A warpgroup skips the product of a tile in
//   which none of its rows keeps a key, and tests the mask per element
//   only in tiles that cross the diagonal or the window's edge.
// * The online softmax runs on the accumulator fragment in registers,
//   with exp2 and the scale folded into scale * log2(e).  A row with no
//   kept key so far keeps its max at -inf and adds nothing, whatever
//   order the tiles come in (as in csrc/flash_attn.cu).
//
// Built with -DREPRO_PIPELINE_CHECK (the checked library of build.py) it
// logs its ring (pipeline_check.cuh): the layout, every mbarrier init,
// expect_tx, TMA box, wait and arrival, and each wgmma group's commit and
// retire with the stage it reads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace fa_sm90;

constexpr int kBQ = 128;          // query rows per block
constexpr int kRowsWG = 64;       // query rows per consumer warpgroup
constexpr int kBK = 64;           // keys per tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 384;     // 2 consumer warpgroups + 1 producer
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kPanelBytes = 64 * 128;  // 64 rows x 64 bf16 columns
constexpr int kBadArgs = 1000;    // returned for arguments refused
constexpr int kNoEncoder = 3000;  // no CUDA-driver cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 2000;  // + the CUresult

// D = 112 (zamba2-7b's head dim) runs in the D = 128 layout: the tensor
// maps have an inner extent of 112, so TMA fills columns 112-127 of every
// Q, K and V tile with zeros.  Q K^T then skips its last 16-column step
// (zeros times zeros), the last 16 columns of P V come out zero, and the
// store writes the 112 real columns only: the output's rows are Hq * 112
// apart, and a 128-column store would write over the next head.
template <int D>
struct Cfg {
  static constexpr int kDP = (D + 63) / 64 * 64;  // the tiles' width
  static constexpr int kPanels = kDP / 64;
  // one 64-row tile: a warpgroup's Q, or one K or V stage
  static constexpr uint32_t kTile = 64 * kDP * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + 2 * kTile;
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBar = kV + kStages * kTile;
  // full_k[2], full_v[2], empty[2], q_full; 1024 bytes of slack to align
  // the tiles (128-byte swizzling repeats every 1024 bytes)
  static constexpr size_t kSmem = kBar + 8 * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, int s_len, int hq,
                            int hkv, int window, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + C::kQ, sk = base + C::kK, sv = base + C::kV;
  const uint32_t bar = base + C::kBar;
  auto full_k = [&](int st) { return bar + 8 * st; };
  auto full_v = [&](int st) { return bar + 16 + 8 * st; };
  auto empty = [&](int st) { return bar + 32 + 8 * st; };
  const uint32_t q_full = bar + 48;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest tiles first
  const int hk = h / (hq / hkv);
  const int q_last = min(q0 + kBQ, s_len) - 1;
  // the key tiles the band needs: from the tile of the first row's first
  // key in the window to the tile of the last row's diagonal
  int kt_lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    kt_lo = first > 0 ? first / kBK : 0;
  }
  const int n_tiles = q_last / kBK - kt_lo + 1;

  if (threadIdx.x == 0) {
    PC_LOG(kLayout, sq, sk, sv, bar, C::kTile);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_expect_tx(q_full, 2 * C::kTile);
      for (int w = 0; w < 2; ++w)
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_4d(sq + w * C::kTile + p * kPanelBytes, &qmap, q_full,
                      64 * p, h, q0 + w * kRowsWG, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = (kt_lo + it) * kBK;
        mbar_wait(empty(st), ph ^ 1);  // the stage's last use has retired
        mbar_expect_tx(full_k(st), C::kTile);
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_4d(sk + st * C::kTile + p * kPanelBytes, &kmap, full_k(st),
                      64 * p, hk, k0, b);
        mbar_expect_tx(full_v(st), C::kTile);
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_4d(sv + st * C::kTile + p * kPanelBytes, &vmap, full_v(st),
                      64 * p, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows r0 .. r0 + 63
    regs_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + wg * kRowsWG;
    // this thread's two rows of every accumulator fragment
    const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
    const uint32_t q_wg = sq + wg * C::kTile;

    float acc[C::kDP / 2];
#pragma unroll
    for (int i = 0; i < C::kDP / 2; ++i) acc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY;  // running max, log2 units
    float l_a = 0.f, l_b = 0.f;              // this thread's part of the sum

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = (kt_lo + it) * kBK;
      // does any row of this warpgroup keep a key of the tile, and does
      // every row keep every key?
      const bool need = r0 < s_len && k0 <= r0 + kRowsWG - 1 &&
                        (window == 0 || k0 + kBK - 1 > r0 - window);
      const bool whole = k0 + kBK - 1 <= r0 &&
                         (window == 0 || k0 > r0 + kRowsWG - 1 - window);
      mbar_wait(full_k(st), ph);
      if (need) {
        // S = Q K^T over D in steps of 16: a 32-byte step inside a
        // 128-byte panel row, the next panel every 4 steps (D = 112: the
        // zero-filled columns 112-127 take no step)
        float s[32];
        const uint32_t k_st = sk + st * C::kTile;
        PC_LANE0_LOG(kMmaCommit, k_st, q_wg, -1, 0, it);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
          wgmma_m64n64k16_ss(s, desc_sw128(q_wg + off, 16, 1024),
                             desc_sw128(k_st + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        PC_LANE0_LOG(kMmaRetire, k_st, q_wg, -1, 0, it);

        // s[4j + e]: row (e < 2 ? row_a : row_b), key k0 + 8j + 2t + (e & 1)
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * scale_log2;
            if (!whole) {
              const int key = k0 + 8 * j + 2 * t + (e & 1);
              const int row = e < 2 ? row_a : row_b;
              if (key > row || (window > 0 && key <= row - window))
                x = -INFINITY;
            }
            s[4 * j + e] = x;
          }
          mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        // the 4 threads of a quad hold one row's 64 keys
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float new_a = fmaxf(m_a, mx_a), new_b = fmaxf(m_b, mx_b);
        // while a row has kept no key its max is -inf: subtract 0 instead,
        // so its probabilities are exp2(-inf) = 0 and nothing is added
        const float use_a = new_a == -INFINITY ? 0.f : new_a;
        const float use_b = new_b == -INFINITY ? 0.f : new_b;
        const float alpha_a = exp2f(m_a - use_a);
        const float alpha_b = exp2f(m_b - use_b);
        m_a = new_a;
        m_b = new_b;
        float sum_a = 0.f, sum_b = 0.f;
        uint32_t pf[16];  // P as the A fragments of 4 k-steps of 16 keys
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p0 = exp2f(s[4 * j] - use_a);
          const float p1 = exp2f(s[4 * j + 1] - use_a);
          const float p2 = exp2f(s[4 * j + 2] - use_b);
          const float p3 = exp2f(s[4 * j + 3] - use_b);
          sum_a += p0 + p1;
          sum_b += p2 + p3;
          const __nv_bfloat162 lo = __floats2bfloat162_rn(p0, p1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p2, p3);
          pf[2 * j] = *reinterpret_cast<const uint32_t*>(&lo);
          pf[2 * j + 1] = *reinterpret_cast<const uint32_t*>(&hi);
        }
        l_a = l_a * alpha_a + sum_a;
        l_b = l_b * alpha_b + sum_b;
#pragma unroll
        for (int j = 0; j < C::kDP / 8; ++j) {
          acc[4 * j] *= alpha_a;
          acc[4 * j + 1] *= alpha_a;
          acc[4 * j + 2] *= alpha_b;
          acc[4 * j + 3] *= alpha_b;
        }

        // O += P V, 16 keys a step: 16 rows of 128 bytes in every panel
        mbar_wait(full_v(st), ph);
        const uint32_t v_st = sv + st * C::kTile;
        fence_regs(acc);  // the rescale and P are written before the fence
        fence_regs(pf);
        PC_LANE0_LOG(kMmaCommit, v_st, -1, -1, 0, it);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          const uint32_t a[4] = {pf[4 * ks], pf[4 * ks + 1], pf[4 * ks + 2],
                                 pf[4 * ks + 3]};
          wgmma_rs<C::kDP>(acc, a, desc_sw128(v_st + ks * 16 * 128,
                                              kPanelBytes, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        PC_LANE0_LOG(kMmaRetire, v_st, -1, -1, 0, it);
      } else {
        mbar_wait(full_v(st), ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // o = acc / l, rounded to bf16 once; rows past S and the padded
    // columns (D = 112) are not stored
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    const int64_t row_stride = (int64_t)hq * D;
    __nv_bfloat16* ob = o + ((int64_t)b * s_len * hq + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row_a < s_len)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_a * row_stride + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      if (row_b < s_len)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_b * row_stride + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv_b,
                                  acc[4 * j + 3] * inv_b);
    }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a CUDA driver API function: reach it through
// the runtime's entry-point query, so the library links against no libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// [B, S, H, D] bf16 as a 4-D map (D, H, S, B), boxes of 64 columns x 1
// head x 64 rows x 1 batch, 128-byte swizzled; columns past D (D = 112's
// second box) and rows past S are filled with zeros
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int b,
             int s, int h, int d) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)s * h * d * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int D>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           void* o, int b, int s, int hq, int hkv, int window, float scale_log2,
           cudaStream_t stream) {
  if constexpr (!PC_BUILT(PC_WGMMA_DIMS, D)) {
    return kBadArgs;  // a head dim this checked build leaves out
  } else {
    const size_t smem = Cfg<D>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // z is scheduled last: every (head, batch) block of the last query
    // tile goes before any block of an earlier one
    const dim3 grid((unsigned)hq, (unsigned)b,
                    (unsigned)((s + kBQ - 1) / kBQ));
    flash_attn_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
        qm, km, vm, static_cast<__nv_bfloat16*>(o), s, hq, hkv, window,
        scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// bf16 only; d is 64, 112, 128 or 256.  Returns 0, a cudaError_t of the
// launch, 1000 for arguments it refuses (the wrapper checks them first),
// 2000 + a CUresult if a tensor map cannot be encoded, or 3000 if the
// CUDA driver's cuTensorMapEncodeTiled cannot be found.  The checked
// build also takes the log and its capacity in records a block.
extern "C" int flash_attn_wgmma_forward(const void* q, const void* k,
                                        const void* v, void* o, int b, int s,
                                        int hq, int hkv, int d, int window,
                                        float scale,
                                        void* stream PC_ENTRY_PARAMS) {
  if (b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 ||
      window < 0 || b > 65535 || (s + kBQ - 1) / kBQ > 65535 ||
      (d != 64 && d != 112 && d != 128 && d != 256)) {
    return kBadArgs;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  CUtensorMap qm, km, vm;
  int err = make_map(encode, &qm, q, b, s, hq, d);
  if (err == 0) err = make_map(encode, &km, k, b, s, hkv, d);
  if (err == 0) err = make_map(encode, &vm, v, b, s, hkv, d);
  if (err != 0) return err;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PC_SET_LOG(st);
  switch (d) {
    case 64:
      return launch<64>(qm, km, vm, o, b, s, hq, hkv, window, scale_log2, st);
    case 112:
      return launch<112>(qm, km, vm, o, b, s, hq, hkv, window, scale_log2, st);
    case 128:
      return launch<128>(qm, km, vm, o, b, s, hq, hkv, window, scale_log2, st);
    default:
      return launch<256>(qm, km, vm, o, b, s, hq, hkv, window, scale_log2, st);
  }
}

// The dynamic shared memory a launch at head dim d asks for
// (Cfg<d>::kSmem), or -1 for a head dim the kernel is not built for.
// The kernel audit holds its budget formula to it.
extern "C" long long flash_attn_wgmma_smem_bytes(int d) {
  switch (d) {
    case 64:
      return (long long)Cfg<64>::kSmem;
    case 112:
      return (long long)Cfg<112>::kSmem;
    case 128:
      return (long long)Cfg<128>::kSmem;
    case 256:
      return (long long)Cfg<256>::kSmem;
    default:
      return -1;
  }
}
