// Weighted neighbor aggregation (the GNN gather) for Hopper, sm_90a:
//
//   out[b, :] = sum_k w[b, k] * feats[idx[b, k], :]
//               (+ w_self[b] * self_rows[b, :] when the epilogue is fused)
//
// feats [N, D] f32 or bf16; idx [B, K] int32; w [B, K] in feats' dtype;
// the optional self_rows [B, D] / w_self [B] and out [B, D] in the
// output dtype: feats' own, or f32 for a bf16 table whose sum is a
// partial that a later call goes on adding to (the fused epilogue of a
// second call then starts from the unrounded partial).  Every product
// and sum is taken in f32; the result is rounded to the output dtype
// once, at the store.
//
// Replaces the TPU kernel neighbor_agg_pallas_tiled
// (src/repro/kernels/neighbor_agg/neighbor_agg.py:192, pallas_call at
// :246, body _make_tiled_kernel :129-189).
//
// What bounds it: bytes.  Each (b, k) edge costs 2*D flops against D
// feature elements read (0.25 flop/byte in f32, 1 in bf16), far below
// the card's ~20 flop/byte balance point, so the least time is the bytes
// the call must move over the 3.35 TB/s of HBM: the distinct feature
// rows it references, idx, w, (self_rows, w_self) and out, each once.
//
// What the design does about it:
// * One warp per output row, lanes along D: lane l owns the columns
//   l, l+32, ... of the row, so each gathered feature row is read by
//   one coalesced warp load per 32 columns and never twice by a block.
// * The block's ids and weights come in as one coalesced 32-wide load
//   per warp and are broadcast with __shfl_sync (the TPU kernel needs
//   scalar prefetch for this; here a block loads its own).
// * The K loop is unrolled so each lane keeps several independent row
//   loads in flight; the f32 accumulator stays in registers (CPT values
//   a lane, CPT = columns per lane, a template parameter up to 8, so a
//   row up to 256 wide is one block column and D = 172 wastes 20 lanes'
//   worth of one tile instead of padding to 256).
// * Ragged B, K and D are masked in the kernel, never padded: no copy
//   of feats is made.  Rows use 64-bit offsets (idx * D overflows int32
//   at 16.7M nodes x 256).  Zero-weight edges are computed like any
//   other (0 * x == 0 exactly for finite x), matching the reference.
// * An id outside [0, N) reads nothing and poisons its output row with
//   NaN instead of reading stray memory.
// * The arithmetic is pinned with __fmul_rn / __fmaf_rn (the fused
//   init is one rounded product, each edge one fused multiply-add, in k
//   order): the slab route (neighbor_agg_slab.cu) takes the same chain,
//   so the two routes are bit-equal whatever the compiler contracts.
// Pipelining the row loads through shared memory (cp.async / TMA) is
// left for a later change; this version is plain and right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // warps per block, one output row each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

template <typename T, typename O, int CPT, bool FUSED>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
    neighbor_agg_kernel(const T* __restrict__ feats,
                        const int32_t* __restrict__ idx,
                        const T* __restrict__ w,
                        const O* __restrict__ self_rows,
                        const O* __restrict__ w_self, O* __restrict__ out,
                        int64_t n, int64_t b_total, int k_total,
                        int d_total) {
  const int lane = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (b >= b_total) return;  // whole warp: b is uniform across lanes
  const int d0 = blockIdx.y * (kWarp * CPT);

  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int d = d0 + lane + kWarp * j;
    acc[j] = 0.f;
    if (FUSED && d < d_total) {
      acc[j] = __fmul_rn(to_f32(w_self[b]),
                         to_f32(self_rows[b * d_total + d]));
    }
  }

  const int32_t* idx_row = idx + b * k_total;
  const T* w_row = w + b * k_total;
  bool bad = false;
  for (int k0 = 0; k0 < k_total; k0 += kWarp) {
    // 32 ids/weights of this row in one coalesced load, one per lane
    const int kk = k0 + lane;
    int32_t my_id = 0;
    float my_w = 0.f;
    if (kk < k_total) {
      my_id = idx_row[kk];
      my_w = to_f32(w_row[kk]);
    }
    const int kn = min(kWarp, k_total - k0);
#pragma unroll 4
    for (int t = 0; t < kn; ++t) {
      const int32_t nid = __shfl_sync(0xffffffffu, my_id, t);
      const float wk = __shfl_sync(0xffffffffu, my_w, t);
      if (nid < 0 || (int64_t)nid >= n) {  // uniform across the warp
        bad = true;
        continue;
      }
      const T* row = feats + (int64_t)nid * d_total;  // 64-bit offset
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = d0 + lane + kWarp * j;
        if (d < d_total) acc[j] = __fmaf_rn(wk, to_f32(row[d]), acc[j]);
      }
    }
  }

  O* out_row = out + b * d_total;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int d = d0 + lane + kWarp * j;
    if (d < d_total) {
      out_row[d] = from_f32<O>(bad ? __int_as_float(0x7fc00000) : acc[j]);
    }
  }
}

template <typename T, typename O, int CPT>
void launch_cpt(const void* feats, const void* idx, const void* w,
                const void* self_rows, const void* w_self, void* out,
                int64_t n, int64_t b, int k, int d, cudaStream_t stream) {
  const dim3 block(kWarp, kRowsPerBlock);
  const int64_t tile = (int64_t)kWarp * CPT;
  const dim3 grid((unsigned)((b + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)((d + tile - 1) / tile));
  const T* f = static_cast<const T*>(feats);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* ww = static_cast<const T*>(w);
  O* o = static_cast<O*>(out);
  if (self_rows != nullptr) {
    neighbor_agg_kernel<T, O, CPT, true><<<grid, block, 0, stream>>>(
        f, i, ww, static_cast<const O*>(self_rows),
        static_cast<const O*>(w_self), o, n, b, k, d);
  } else {
    neighbor_agg_kernel<T, O, CPT, false><<<grid, block, 0, stream>>>(
        f, i, ww, nullptr, nullptr, o, n, b, k, d);
  }
}

template <typename T, typename O>
void launch(const void* feats, const void* idx, const void* w,
            const void* self_rows, const void* w_self, void* out, int64_t n,
            int64_t b, int k, int d, cudaStream_t stream) {
  // columns per lane: the fewest that cover D in one block column, at
  // most 8 (a 256-wide tile); wider rows take several block columns
  int cpt = (d + kWarp - 1) / kWarp;
  if (cpt > 8) cpt = 8;
  switch (cpt) {
#define NA_CASE(C)                                                        \
  case C:                                                                 \
    launch_cpt<T, O, C>(feats, idx, w, self_rows, w_self, out, n, b, k, \
                        d, stream);                                       \
    break;
    NA_CASE(1)
    NA_CASE(2)
    NA_CASE(3)
    NA_CASE(4)
    NA_CASE(5)
    NA_CASE(6)
    NA_CASE(7)
    default:
      launch_cpt<T, O, 8>(feats, idx, w, self_rows, w_self, out, n, b, k,
                          d, stream);
#undef NA_CASE
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, 2 = a bfloat16 table and w with self_rows, w_self and
// out in float32.  self_rows/w_self both null (plain) or both set
// (fused).
// Returns the cudaError_t of the launch (0 = launched); 1000 for an
// unknown dtype or bad arguments.  Launches on `stream`, never syncs.
extern "C" int neighbor_agg_forward(int dtype, const void* feats,
                                    const void* idx, const void* w,
                                    const void* self_rows,
                                    const void* w_self, void* out,
                                    long long n, long long b, int k, int d,
                                    void* stream) {
  if (b <= 0 || d <= 0 || k < 0 || n < 0) return 1000;
  if ((self_rows == nullptr) != (w_self == nullptr)) return 1000;
  if ((b + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, float>(feats, idx, w, self_rows, w_self, out, n, b, k, d,
                         s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(feats, idx, w, self_rows, w_self,
                                         out, n, b, k, d, s);
  } else if (dtype == 2) {
    launch<__nv_bfloat16, float>(feats, idx, w, self_rows, w_self, out, n,
                                 b, k, d, s);
  } else {
    return 1000;
  }
  return static_cast<int>(cudaGetLastError());
}
