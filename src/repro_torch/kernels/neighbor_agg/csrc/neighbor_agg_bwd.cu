// Backward of the weighted neighbor aggregation for Hopper, sm_90a.
//
// Forward:  out[b, :] = sum_k w[b, k] * feats[idx[b, k], :]
//                       (+ w_self[b] * self_rows[b, :] when fused)
// Given the cotangent g [B, D] of out, every optional output is
//
//   dfeats[n, :]  += w[b, k] * g[b, :]   for every (b, k) with idx = n
//   dw[b, k]       = <g[b, :], feats[idx[b, k], :]>
//   dself[b, :]    = w_self[b] * g[b, :]                 (fused only)
//   dw_self[b]     = <g[b, :], self_rows[b, :]>           (fused only)
//
// feats, w, g, self_rows, w_self, dw, dself, dw_self are f32 or bf16 (one
// dtype); idx is int32; dfeats is an f32 [N, D] buffer the caller zeroes
// (the wrapper casts it to feats' dtype once).  Products and sums are
// taken in f32; dw, dself, dw_self round to the storage dtype once.
//
// Replaces the reference's backward of the TPU kernel
// neighbor_agg_pallas_tiled: the lax.scan over K in _agg_bwd and
// _agg_self_bwd (src/repro/kernels/neighbor_agg/ops.py:55-111).  That
// scan exists to keep the [B, K, D] gather out of memory; here no gather
// is ever materialised either.
//
// What bounds it: bytes.  Per edge it moves one D-wide feature row in
// (for dw) and one D-wide f32 row of atomics out (for dfeats), against
// 4*D flops, so the least time is the bytes the call must move over the
// 3.35 TB/s of HBM: g, idx, w, the distinct feature rows read, dfeats and
// dw written once (plus self_rows, w_self, dself, dw_self when fused).
// The f32 atomics are what keep it above that: each goes to L2.
//
// What the design does about it:
// * One warp per output row b (8 rows a block), lanes along D, as in the
//   forward: g[b] is read once into registers in f32 (CPT columns a lane,
//   CPT = ceil(D / 32) up to 8) and reused for every k.  Rows wider than
//   256 loop over 256-column chunks and re-read g (L1-resident).
// * Ids and weights of the row come in as one coalesced 32-wide load and
//   are broadcast with __shfl_sync.
// * dw: each lane's partial dot is warp-reduced with __shfl_xor_sync and
//   written by lane 0; dfeats: one coalesced run of f32 atomicAdds per
//   (b, k) edge, one per column.  The order in which atomics land differs
//   run to run, so dfeats is deterministic only where no two edges share
//   a row (the mini-batch path's identity ids).
// * Edges of weight 0 send no atomics: their contribution w*g is +-0,
//   which leaves every finite sum unchanged, and the ELL layout points
//   all of its padding edges at row 0, whose atomics would otherwise
//   serialise.  (Only a non-finite g differs: the reference would spread
//   its NaN into row 0 through a padding edge.)
// * dfeats or dw is skipped entirely when its pointer is null (autograd
//   did not ask for it), and so are dself and dw_self.
// * Ragged B, K and D are masked, never padded; rows use 64-bit offsets.
// * An id outside [0, N) sends no atomics and sets its dw[b, k] to NaN,
//   like the forward's poisoned row.

#include "common.cuh"

namespace {

using nagg::from_f32;
using nagg::kFull;
using nagg::kWarp;
using nagg::to_f32;
using nagg::warp_sum;

constexpr int kRowsPerBlock = 8;  // warps per block, one output row each

template <typename T, int CPT>
__device__ __forceinline__ void load_g(float (&gr)[CPT], const T* g_row,
                                       int d0, int lane, int d_total) {
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int d = d0 + lane + kWarp * j;
    gr[j] = d < d_total ? to_f32(g_row[d]) : 0.f;
  }
}

template <typename T, int CPT, bool FUSED>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
    neighbor_agg_bwd_kernel(const T* __restrict__ feats,
                            const int32_t* __restrict__ idx,
                            const T* __restrict__ w,
                            const T* __restrict__ g,
                            const T* __restrict__ self_rows,
                            const T* __restrict__ w_self,
                            float* __restrict__ dfeats, T* __restrict__ dw,
                            T* __restrict__ dself, T* __restrict__ dw_self,
                            int64_t n, int64_t b_total, int k_total,
                            int d_total) {
  constexpr int kTile = kWarp * CPT;
  const int lane = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (b >= b_total) return;  // whole warp: b is uniform across lanes
  const bool one_chunk = d_total <= kTile;
  const T* g_row = g + b * d_total;

  float gr[CPT];
  load_g<T, CPT>(gr, g_row, 0, lane, d_total);

  if (FUSED && (dself != nullptr || dw_self != nullptr)) {
    const float ws = to_f32(w_self[b]);
    const T* s_row = self_rows + b * d_total;
    float dot = 0.f;
    for (int d0 = 0; d0 < d_total; d0 += kTile) {
      if (d0 > 0) load_g<T, CPT>(gr, g_row, d0, lane, d_total);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = d0 + lane + kWarp * j;
        if (d < d_total) {
          if (dself != nullptr) dself[b * d_total + d] = from_f32<T>(ws * gr[j]);
          dot += gr[j] * to_f32(s_row[d]);
        }
      }
    }
    dot = warp_sum(dot);
    if (lane == 0 && dw_self != nullptr) dw_self[b] = from_f32<T>(dot);
    if (!one_chunk) load_g<T, CPT>(gr, g_row, 0, lane, d_total);
  }

  if (dfeats == nullptr && dw == nullptr) return;
  const int32_t* idx_row = idx + b * k_total;
  const T* w_row = w + b * k_total;
  for (int k0 = 0; k0 < k_total; k0 += kWarp) {
    const int kk = k0 + lane;
    int32_t my_id = 0;
    float my_w = 0.f;
    if (kk < k_total) {
      my_id = idx_row[kk];
      my_w = to_f32(w_row[kk]);
    }
    const int kn = min(kWarp, k_total - k0);
    for (int t = 0; t < kn; ++t) {
      const int32_t nid = __shfl_sync(kFull, my_id, t);
      const float wk = __shfl_sync(kFull, my_w, t);
      const bool bad = nid < 0 || (int64_t)nid >= n;  // warp-uniform
      const bool scatter = dfeats != nullptr && !bad && wk != 0.f;
      const int64_t row_off = (int64_t)nid * d_total;  // 64-bit offset
      float dot = 0.f;
      for (int d0 = 0; d0 < d_total; d0 += kTile) {
        if (d0 > 0) load_g<T, CPT>(gr, g_row, d0, lane, d_total);
        if (!bad) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int d = d0 + lane + kWarp * j;
            if (d < d_total) {
              if (dw != nullptr) dot += gr[j] * to_f32(feats[row_off + d]);
              if (scatter) atomicAdd(dfeats + row_off + d, wk * gr[j]);
            }
          }
        }
      }
      if (!one_chunk) load_g<T, CPT>(gr, g_row, 0, lane, d_total);
      if (dw != nullptr) {
        dot = warp_sum(dot);
        if (lane == 0) {
          dw[b * k_total + k0 + t] =
              from_f32<T>(bad ? nagg::quiet_nan() : dot);
        }
      }
    }
  }
}

template <typename T, int CPT>
void launch_cpt(const void* feats, const void* idx, const void* w,
                const void* g, const void* self_rows, const void* w_self,
                void* dfeats, void* dw, void* dself, void* dw_self,
                int64_t n, int64_t b, int k, int d, cudaStream_t stream) {
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid((unsigned)((b + kRowsPerBlock - 1) / kRowsPerBlock));
  const T* f = static_cast<const T*>(feats);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* ww = static_cast<const T*>(w);
  const T* gg = static_cast<const T*>(g);
  float* df = static_cast<float*>(dfeats);
  T* dww = static_cast<T*>(dw);
  if (self_rows != nullptr) {
    neighbor_agg_bwd_kernel<T, CPT, true><<<grid, block, 0, stream>>>(
        f, i, ww, gg, static_cast<const T*>(self_rows),
        static_cast<const T*>(w_self), df, dww, static_cast<T*>(dself),
        static_cast<T*>(dw_self), n, b, k, d);
  } else {
    neighbor_agg_bwd_kernel<T, CPT, false><<<grid, block, 0, stream>>>(
        f, i, ww, gg, nullptr, nullptr, df, dww, nullptr, nullptr, n, b, k,
        d);
  }
}

template <typename T>
void launch(const void* feats, const void* idx, const void* w,
            const void* g, const void* self_rows, const void* w_self,
            void* dfeats, void* dw, void* dself, void* dw_self, int64_t n,
            int64_t b, int k, int d, cudaStream_t stream) {
  // columns per lane: the fewest that cover D in one chunk, at most 8
  int cpt = (d + kWarp - 1) / kWarp;
  if (cpt > 8) cpt = 8;
  switch (cpt) {
#define NAB_CASE(C)                                                         \
  case C:                                                                   \
    launch_cpt<T, C>(feats, idx, w, g, self_rows, w_self, dfeats, dw,       \
                     dself, dw_self, n, b, k, d, stream);                   \
    break;
    NAB_CASE(1)
    NAB_CASE(2)
    NAB_CASE(3)
    NAB_CASE(4)
    NAB_CASE(5)
    NAB_CASE(6)
    NAB_CASE(7)
    default:
      launch_cpt<T, 8>(feats, idx, w, g, self_rows, w_self, dfeats, dw,
                       dself, dw_self, n, b, k, d, stream);
#undef NAB_CASE
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  self_rows/w_self both null (plain) or both set (fused);
// dfeats (f32, zeroed by the caller), dw, dself, dw_self may each be null
// (not computed).  Returns the cudaError_t of the launch (0 = launched);
// 1000 for an unknown dtype or bad arguments.  Launches on `stream`,
// never syncs.
extern "C" int neighbor_agg_backward(int dtype, const void* feats,
                                     const void* idx, const void* w,
                                     const void* g, const void* self_rows,
                                     const void* w_self, void* dfeats,
                                     void* dw, void* dself, void* dw_self,
                                     long long n, long long b, int k, int d,
                                     void* stream) {
  if (b <= 0 || d <= 0 || k < 0 || n < 0) return nagg::kBadArgs;
  if ((self_rows == nullptr) != (w_self == nullptr)) return nagg::kBadArgs;
  if (self_rows == nullptr && (dself != nullptr || dw_self != nullptr)) {
    return nagg::kBadArgs;
  }
  if ((b + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL) {
    return nagg::kBadArgs;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(feats, idx, w, g, self_rows, w_self, dfeats, dw, dself,
                  dw_self, n, b, k, d, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(feats, idx, w, g, self_rows, w_self, dfeats, dw,
                          dself, dw_self, n, b, k, d, s);
  } else {
    return nagg::kBadArgs;
  }
  return static_cast<int>(cudaGetLastError());
}
