// Reverse-index backward of the weighted neighbor aggregation (dfeats
// only) for Hopper, sm_90a.
//
// Forward:  out[b, :] = sum_k w[b, k] * feats[idx[b, k], :]
// Given the cotangent g [B, D] of out,
//
//   dfeats[n, :] = sum over the edges e = b*K + k with idx[b, k] = n
//                  of w[e] * g[b, :]                          (= A^T g)
//
// taken here as a gather over the transposed ELL: the reverse index lists
// row n's edges as edges[indptr[n] .. indptr[n+1]), flat ELL positions in
// ascending order (built once per graph by ops.build_reverse_index).  w
// and g are f32 or bf16 (one dtype), indptr and edges int32, dfeats [N, D]
// in w's dtype; products and sums are taken in f32 and each output value
// rounds to the storage dtype once.
//
// Replaces the dfeats half of the reference's backward of the TPU kernel
// neighbor_agg_pallas_tiled: the scatter-add inside the lax.scan of
// _agg_bwd / _agg_self_bwd (src/repro/kernels/neighbor_agg/ops.py:55-111).
// On the full-graph path the atomic kernel (neighbor_agg_bwd.cu) sent one
// f32 atomicAdd to L2 per edge per column into a zeroed f32 buffer that
// was then cast; this kernel sends none.
//
// What bounds it: bytes.  It reads each kept edge's position and weight,
// one D-wide g row per edge and writes dfeats once, against 2*D flops per
// edge; the least time is g, w, the index and dfeats over the 3.35 TB/s
// of HBM.  What keeps it above that: g rows are re-read once per edge
// that names them (about 28 times each on the full graph), from L2 or
// HBM, in the random order of the graph.
//
// What the design does about it:
// * One warp per source row n (8 rows a block), lanes along D (CPT
//   columns a lane, CPT = ceil(D / 32) up to 8, as in the forward); the
//   row's sum stays in f32 registers and is written once, so there is no
//   zero fill, no cast pass and no atomic.  A row with no edges is
//   written as zeros.
// * Edge positions and their weights come in 32 at a time with one
//   coalesced load and are broadcast with __shfl_sync; the g rows of
//   kUnroll edges are loaded before any is added, so their loads are in
//   flight together.
// * The edges are added in the index's order, the same every run: the
//   result is bit-identical from run to run.
// * An edge of weight 0 adds nothing (its g row is read but not added),
//   as in the atomic kernel: only a non-finite g behind such an edge
//   would differ from a plain product.
// * D beyond 256 loops over 256-column chunks, walking the row's edges
//   again; rows and g rows use 64-bit offsets.

#include "common.cuh"

namespace {

using nagg::from_f32;
using nagg::kFull;
using nagg::kWarp;
using nagg::to_f32;

constexpr int kRowsPerBlock = 8;  // warps per block, one source row each
constexpr int kUnroll = 4;        // edges whose g rows load together

template <typename T, int CPT>
__device__ __forceinline__ void load_row(float (&v)[CPT], const T* row,
                                         int d0, int lane, int d_total) {
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int d = d0 + lane + kWarp * j;
    v[j] = d < d_total ? to_f32(row[d]) : 0.f;
  }
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
    neighbor_agg_bwd_csr_kernel(const int32_t* __restrict__ indptr,
                                const int32_t* __restrict__ edges,
                                const T* __restrict__ w,
                                const T* __restrict__ g,
                                T* __restrict__ dfeats, int64_t n,
                                int k_total, int d_total) {
  constexpr int kTile = kWarp * CPT;
  const int lane = threadIdx.x;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= n) return;  // whole warp: row is uniform across lanes
  const int e_begin = indptr[row];
  const int e_end = indptr[row + 1];
  T* out = dfeats + row * d_total;

  for (int d0 = 0; d0 < d_total; d0 += kTile) {
    float acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
    for (int base = e_begin; base < e_end; base += kWarp) {
      int32_t my_e = 0;
      float my_w = 0.f;
      if (base + lane < e_end) {
        my_e = edges[base + lane];
        my_w = to_f32(w[my_e]);
      }
      const int cnt = min(kWarp, e_end - base);
      int t = 0;
      for (; t + kUnroll <= cnt; t += kUnroll) {
        float v[kUnroll][CPT];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int32_t e = __shfl_sync(kFull, my_e, t + u);
          wv[u] = __shfl_sync(kFull, my_w, t + u);
          load_row<T, CPT>(v[u], g + (int64_t)(e / k_total) * d_total, d0,
                           lane, d_total);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            if (wv[u] != 0.f) acc[j] += wv[u] * v[u][j];
          }
        }
      }
      for (; t < cnt; ++t) {
        const int32_t e = __shfl_sync(kFull, my_e, t);
        const float we = __shfl_sync(kFull, my_w, t);
        if (we == 0.f) continue;  // warp-uniform
        float v[CPT];
        load_row<T, CPT>(v, g + (int64_t)(e / k_total) * d_total, d0, lane,
                         d_total);
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[j] += we * v[j];
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = d0 + lane + kWarp * j;
      if (d < d_total) out[d] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T, int CPT>
void launch_cpt(const void* indptr, const void* edges, const void* w,
                const void* g, void* dfeats, int64_t n, int k, int d,
                cudaStream_t stream) {
  const dim3 block(kWarp, kRowsPerBlock);
  const dim3 grid((unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock));
  neighbor_agg_bwd_csr_kernel<T, CPT><<<grid, block, 0, stream>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(edges),
      static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<T*>(dfeats), n, k, d);
}

template <typename T>
void launch(const void* indptr, const void* edges, const void* w,
            const void* g, void* dfeats, int64_t n, int k, int d,
            cudaStream_t stream) {
  // columns per lane: the fewest that cover D in one chunk, at most 8
  int cpt = (d + kWarp - 1) / kWarp;
  if (cpt > 8) cpt = 8;
  switch (cpt) {
#define NABC_CASE(C)                                                        \
  case C:                                                                   \
    launch_cpt<T, C>(indptr, edges, w, g, dfeats, n, k, d, stream);         \
    break;
    NABC_CASE(1)
    NABC_CASE(2)
    NABC_CASE(3)
    NABC_CASE(4)
    NABC_CASE(5)
    NABC_CASE(6)
    NABC_CASE(7)
    default:
      launch_cpt<T, 8>(indptr, edges, w, g, dfeats, n, k, d, stream);
#undef NABC_CASE
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  indptr [n + 1] and edges (positions < b * k) int32, w
// [b, k], g [b, d], dfeats [n, d] (every row written).  Returns the
// cudaError_t of the launch (0 = launched); 1000 for an unknown dtype or
// bad arguments.  Launches on `stream`, never syncs.
extern "C" int neighbor_agg_backward_csr(int dtype, const void* indptr,
                                         const void* edges, const void* w,
                                         const void* g, void* dfeats,
                                         long long n, long long b, int k,
                                         int d, void* stream) {
  if (n <= 0 || d <= 0 || k < 0 || b < 0) return nagg::kBadArgs;
  if (b * (long long)k > 0x7fffffffLL) return nagg::kBadArgs;  // int32 e
  if ((n + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL) {
    return nagg::kBadArgs;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(indptr, edges, w, g, dfeats, n, k, d, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(indptr, edges, w, g, dfeats, n, k, d, s);
  } else {
    return nagg::kBadArgs;
  }
  return static_cast<int>(cudaGetLastError());
}
