// Weighted neighbor aggregation (the GNN gather) for Hopper, sm_90a, in
// column slabs that L2 holds:
//
//   out[b, :] = sum_k w[b, k] * feats[idx[b, k], :]
//               (+ w_self[b] * self_rows[b, :] when the epilogue is fused)
//
// The same function and contract as neighbor_agg.cu (the "direct" route):
// feats [N, D] f32 or bf16; idx [B, K] int32; w [B, K] and the optional
// self_rows [B, D] / w_self [B] in feats' dtype; out [B, D] in feats'
// dtype; products and sums in f32, one rounding at the store.
//
// Replaces the TPU kernel neighbor_agg_pallas_tiled
// (src/repro/kernels/neighbor_agg/neighbor_agg.py:192, pallas_call at
// :246), whose grid already cuts the feature axis into d_tile columns
// (:213) and fetches feats[nid, di*d_tile : (di+1)*d_tile] per row (:152).
//
// What bounds it: bytes, and where they come from.  At the full-graph
// shape (B = N = 524,288, K = 32) every table row is read about 28 times
// in the graph's random node order, so the gather, not the table, is the
// traffic: 16.8M row reads (4.3 GB at D = 128 bf16) from L2 or HBM.  The
// direct route (neighbor_agg.cu) reads whole rows in one pass, in lanes
// up to 16 bytes wide (common.cuh's gather_pass).  Here D is cut
// into slabs of S bytes a row, and all row blocks of slab 0 run before
// slab 1, so a pass's working set is N * S bytes instead of the table.
//
// What the design does about it:
// * The grid is (row blocks, slabs): the linear block index runs rows
//   fastest, and blocks are dispatched in about that order, so the slabs
//   follow one another in time (one launch, no persistent counter).
// * A warp serves 32 / LPR output rows; a row's LPR lanes each own
//   8 bytes of the slab (4 bf16 or 2 f32 columns), so a row's slab is
//   one 8-byte load a lane (the widest load every bf16 row at D = 172
//   allows: 344 B rows are only 8-byte aligned).  S = 8 * LPR bytes;
//   LPR = 4, 8, 16, 32 for S = 32, 64, 128, 256.
// * Every slab is read in place from the row-major table; nothing is
//   copied.  A 128 B slab of rows that are a whole number of 128 B L2
//   lines is whole lines; narrower slabs, and slabs of rows that
//   straddle lines, read parts of lines (kept for the width sweep of
//   chip_smoke.py, which times each width at the full-graph shape).
// * Each lane walks its row's K edges in order and keeps its columns'
//   sums in f32 registers: each output element's sum is the same chain
//   of multiply-adds, in the same order, as in neighbor_agg.cu (both
//   pinned with __fmul_rn / __fmaf_rn), so the two routes give bit-equal
//   results.  A row's ids and weights come in LPR at a time, one
//   coalesced load across its lanes, broadcast with __shfl_sync inside
//   the row's lane group; a full group of LPR edges is unrolled so its
//   row loads are in flight together.
// * Cache hints, no global cache state: slab rows load with an
//   L2::evict_last policy; idx, w, self_rows, w_self and out stream
//   with the .cs (evict-first) loads and stores, so data used once does
//   not evict the slab.  No persisting-L2 limit or stream
//   access-policy window is set: both are process-wide and would change
//   every other kernel of the step.
// * Ragged B, K and D are masked, never padded (the last slab may be
//   narrower; lanes past D load and store nothing); where rows are not
//   8-byte aligned (D * sizeof(T) not a multiple of 8) table, self_rows
//   and out take element loads and stores on the same columns.  K = 0
//   gives zeros, or w_self * self_rows when fused (the fused epilogue
//   starts each slab's accumulator).  Offsets are 64-bit.
//   Zero-weight edges are computed like any other (0 * x == 0 for finite
//   x).  An id outside [0, N) reads nothing and makes its output row NaN
//   in every slab.
//
// Measured on the H100 (PERF.md, section 6): the slabs do not make the
// gather L2-resident at the full-graph shape; what pays is whole-line
// requests of 8 bytes a lane.  So the host's plan (ops.tiled_plan) takes
// S = 128 B where rows are whole lines, the table exceeds 32 MiB and the
// call gathers, from ids that repeat, for every row of the table
// (B >= N: the full-graph forward); the direct route elsewhere (the
// serving build's chunks, B < N, start with L2 cold, where the slab
// route measured slower).  It passes slab_cols = S / sizeof(T).

#include "common.cuh"

namespace {

using nagg::from_f32;
using nagg::kFull;
using nagg::kWarp;
using nagg::quiet_nan;

constexpr int kWarpsPerBlock = 8;
constexpr int kLaneBytes = 8;  // one lane's share of a row's slab

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// table loads, kept in L2 (evict_last)
__device__ __forceinline__ uint2 ld_keep8(const void* p, uint64_t policy) {
  uint2 v;
  asm("ld.global.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ float ld_keep(const float* p, uint64_t policy) {
  float v;
  asm("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v)
      : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ float ld_keep(const __nv_bfloat16* p,
                                         uint64_t policy) {
  unsigned short v;
  asm("ld.global.L2::cache_hint.u16 %0, [%1], %2;"
      : "=h"(v)
      : "l"(p), "l"(policy));
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// streamed (used once) loads and stores
__device__ __forceinline__ float ld_once(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_once(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void st_once(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_once(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(from_f32<__nv_bfloat16>(v)));
}

// 8 bytes as f32 values: 2 f32 or 4 bf16 (bf16 -> f32 is exact: the
// bits move to the top half, as __bfloat162float does)
__device__ __forceinline__ void unpack8(uint2 v, float (&x)[2]) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
}
__device__ __forceinline__ void unpack8(uint2 v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ uint2 pack8(const float (&x)[2], float*) {
  return make_uint2(__float_as_uint(x[0]), __float_as_uint(x[1]));
}
__device__ __forceinline__ uint2 pack8(const float (&x)[4], __nv_bfloat16*) {
  const auto h = [](float v) {
    return (unsigned)__bfloat16_as_ushort(from_f32<__nv_bfloat16>(v));
  };
  return make_uint2(h(x[0]) | (h(x[1]) << 16), h(x[2]) | (h(x[3]) << 16));
}

template <typename T, int LPR, bool ALIGNED, bool FUSED>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    neighbor_agg_slab_kernel(const T* __restrict__ feats,
                             const int32_t* __restrict__ idx,
                             const T* __restrict__ w,
                             const T* __restrict__ self_rows,
                             const T* __restrict__ w_self,
                             T* __restrict__ out, int64_t n, int64_t b_total,
                             int k_total, int d_total, int slab_cols) {
  constexpr int CPL = kLaneBytes / sizeof(T);  // columns a lane owns
  constexpr int kRowsPerWarp = kWarp / LPR;
  const int lane = threadIdx.x % kWarp;
  const int gl = lane % LPR;  // lane within its row's group
  const int64_t b = ((int64_t)blockIdx.x * kWarpsPerBlock +
                     threadIdx.x / kWarp) * kRowsPerWarp + lane / LPR;
  const bool row_ok = b < b_total;
  const int c_hi = min((int)blockIdx.y * slab_cols + slab_cols, d_total);
  const int c0 = (int)blockIdx.y * slab_cols + gl * CPL;
  const int nc = max(0, min(CPL, c_hi - c0));  // this lane's columns
  const T* slab = feats + blockIdx.y * slab_cols + gl * CPL;
  const uint64_t policy = evict_last_policy();

  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    acc[j] = 0.f;
    if (FUSED && row_ok && j < nc) {
      acc[j] = __fmul_rn(ld_once(w_self + b),
                         ld_once(self_rows + b * d_total + c0 + j));
    }
  }

  const int32_t* idx_row = idx + b * k_total;
  const T* w_row = w + b * k_total;
  bool bad = false;
  // one edge: every lane of the warp runs it (the shuffles need them all)
  const auto edge = [&](int32_t my_id, float my_w, int t) {
    const int32_t nid = __shfl_sync(kFull, my_id, t, LPR);
    const float wk = __shfl_sync(kFull, my_w, t, LPR);
    if (nid < 0 || (int64_t)nid >= n) {  // uniform across the row's lanes
      bad = true;
      return;
    }
    const T* row = slab + (int64_t)nid * d_total;  // 64-bit offset
    if (ALIGNED && nc == CPL) {
      float x[CPL];
      unpack8(ld_keep8(row, policy), x);
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] = __fmaf_rn(wk, x[j], acc[j]);
    } else {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (j < nc) {
          acc[j] = __fmaf_rn(wk, ld_keep(row + j, policy), acc[j]);
        }
      }
    }
  };
  for (int k0 = 0; k0 < k_total; k0 += LPR) {
    // LPR ids/weights of this row in one coalesced load, one a lane
    const int kk = k0 + gl;
    int32_t my_id = 0;
    float my_w = 0.f;
    if (row_ok && kk < k_total) {
      my_id = __ldcs(idx_row + kk);
      my_w = ld_once(w_row + kk);
    }
    if (k_total - k0 >= LPR) {  // uniform: every row has K edges
#pragma unroll
      for (int t = 0; t < LPR; ++t) edge(my_id, my_w, t);
    } else {
      for (int t = 0; t < k_total - k0; ++t) edge(my_id, my_w, t);
    }
  }

  if (!row_ok || nc == 0) return;
  if (bad) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = quiet_nan();
  }
  T* dst = out + b * d_total + c0;
  if (ALIGNED && nc == CPL) {
    __stcs(reinterpret_cast<uint2*>(dst), pack8(acc, dst));
  } else {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (j < nc) st_once(dst + j, acc[j]);
    }
  }
}

template <typename T, int LPR, bool ALIGNED>
void launch_lpr(const void* feats, const void* idx, const void* w,
                const void* self_rows, const void* w_self, void* out,
                int64_t n, int64_t b, int k, int d, int slab_cols,
                cudaStream_t stream) {
  constexpr int64_t kRowsPerBlock = (int64_t)kWarpsPerBlock * (kWarp / LPR);
  const dim3 grid((unsigned)((b + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)((d + slab_cols - 1) / slab_cols));
  const dim3 block(kWarp * kWarpsPerBlock);
  const T* f = static_cast<const T*>(feats);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* ww = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (self_rows != nullptr) {
    neighbor_agg_slab_kernel<T, LPR, ALIGNED, true>
        <<<grid, block, 0, stream>>>(f, i, ww,
                                     static_cast<const T*>(self_rows),
                                     static_cast<const T*>(w_self), o, n, b,
                                     k, d, slab_cols);
  } else {
    neighbor_agg_slab_kernel<T, LPR, ALIGNED, false>
        <<<grid, block, 0, stream>>>(f, i, ww, nullptr, nullptr, o, n, b, k,
                                     d, slab_cols);
  }
}

template <typename T>
int launch(const void* feats, const void* idx, const void* w,
           const void* self_rows, const void* w_self, void* out, int64_t n,
           int64_t b, int k, int d, int slab_cols, cudaStream_t stream) {
  const int lpr = slab_cols * (int)sizeof(T) / kLaneBytes;
  if (slab_cols * (int)sizeof(T) % kLaneBytes != 0) return nagg::kBadArgs;
  // 8-byte loads and stores of feats, self_rows and out need every row
  // (D * sizeof(T) bytes apart) and base pointer on an 8-byte boundary;
  // else every lane takes element loads and stores
  const auto al = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % kLaneBytes == 0;
  };
  const bool aligned = (int64_t)d * (int64_t)sizeof(T) % kLaneBytes == 0 &&
                       al(feats) && al(self_rows) && al(out);
#define NS_CASE(L)                                                         \
  case L:                                                                  \
    if (aligned) {                                                         \
      launch_lpr<T, L, true>(feats, idx, w, self_rows, w_self, out, n, b, \
                             k, d, slab_cols, stream);                     \
    } else {                                                               \
      launch_lpr<T, L, false>(feats, idx, w, self_rows, w_self, out, n, b, \
                              k, d, slab_cols, stream);                    \
    }                                                                      \
    return 0;
  switch (lpr) {
    NS_CASE(4)
    NS_CASE(8)
    NS_CASE(16)
    NS_CASE(32)
    default:
      return nagg::kBadArgs;
  }
#undef NS_CASE
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  self_rows/w_self both null (plain) or both set (fused).
// slab_cols: columns a slab, so that slab_cols * sizeof(dtype) is 32, 64,
// 128 or 256 bytes; slab s covers columns [s * slab_cols, min((s + 1) *
// slab_cols, d)).  Returns
// the cudaError_t of the launches (0 = launched); 1000 for an unknown
// dtype or bad arguments.  Launches on `stream`, never syncs.
extern "C" int neighbor_agg_forward_slab(int dtype, const void* feats,
                                         const void* idx, const void* w,
                                         const void* self_rows,
                                         const void* w_self, void* out,
                                         long long n,
                                         long long b, int k, int d,
                                         int slab_cols, void* stream) {
  if (b <= 0 || d <= 0 || k < 0 || n < 0 || slab_cols <= 0) {
    return nagg::kBadArgs;
  }
  if ((self_rows == nullptr) != (w_self == nullptr)) return nagg::kBadArgs;
  if ((d + slab_cols - 1) / slab_cols > 65535) return nagg::kBadArgs;
  if ((b + 7) / 8 > 0x7fffffffLL) return nagg::kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch<float>(feats, idx, w, self_rows, w_self, out, n, b, k, d,
                        slab_cols, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(feats, idx, w, self_rows, w_self, out, n,
                                b, k, d, slab_cols, s);
  } else {
    return nagg::kBadArgs;
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
