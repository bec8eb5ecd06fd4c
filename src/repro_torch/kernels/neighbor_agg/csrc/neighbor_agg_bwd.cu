// Backward of the weighted neighbor aggregation for Hopper, sm_90a, in
// two modes: one library, two C entry points.
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
// * Identity mode (neighbor_agg_backward_identity): the ids are the
//   identity, idx[b, k] = b*K + k, so feats is a [B*K, D] table of
//   already-gathered rows (the mini-batch path's fan-out levels, flattened
//   by ops.neighbor_agg_batch and shard by shard by
//   ops.neighbor_agg_batch_sharded).  No id is read and no two edges
//   share a row: dfeats[b*K + k, :] = w[b, k] * g[b, :] is written once
//   with plain stores, straight in feats' dtype, every row of it (so the
//   caller allocates it without a zero fill, and there is no f32 buffer
//   and no cast pass).
// * General mode (neighbor_agg_backward): any ids, some repeating.
//   dfeats is an f32 [N, D] buffer the caller zeroes and casts once,
//   summed with atomics.  No model path reaches its dfeats: the full-graph,
//   cluster and sharded paths send dfeats to the reverse-index kernel
//   (neighbor_agg_bwd_csr.cu) and the mini-batch paths to the identity
//   mode.  It serves dw / dself / dw_self with a null dfeats (GCN's
//   full-graph dself) and direct calls of neighbor_agg(use_kernel=True)
//   without a reverse index.
//
// feats, w, g, self_rows, w_self, dw, dself, dw_self are f32 or bf16 (one
// dtype); idx is int32.  Every product is one __fmul_rn in f32 and every
// dot one __fmaf_rn chain (the same chain in both modes), each result
// rounded to its storage dtype once: the identity mode's dfeats is the
// general mode's f32 0 + w*g cast once, bit for bit (up to the sign of a
// zero), and so are dw, dself and dw_self wherever the two launches pick
// the same lane width (they do for outputs the wrapper allocates).
//
// Replaces the reference's backward of the TPU kernel
// neighbor_agg_pallas_tiled: the lax.scan over K in _agg_bwd and
// _agg_self_bwd (src/repro/kernels/neighbor_agg/ops.py:55-111).  That
// scan exists to keep the [B, K, D] gather out of memory; here no gather
// is ever materialised either.
//
// What bounds it: bytes.  Identity mode: g and w read, dfeats written
// once (B*K*D elements, the bulk), table rows read only for dw, against
// one multiply per dfeats element.  General mode: g, idx, w, the distinct
// feature rows (for dw) read, dfeats and dw written once; its f32 atomics
// go to L2 and are what keep it above that.
//
// What the design does about it (both modes):
// * One warp per output row b (8 rows a block), lanes along D in V-wide
//   vectors (common.cuh: 16-byte loads and stores wherever D and the base
//   pointers allow, 8-, 4- or 2-byte ones elsewhere; bf16 D = 172 has
//   344-byte rows, 8-byte aligned, so V = 4).  g[b] is read once into f32
//   registers (256 columns a pass) and reused for every k; rows wider than
//   256 loop over passes and re-read g (L1-resident).
// * The row's weights (and ids) come in as one coalesced 32-wide load and
//   are broadcast with __shfl_sync.
// * dw: each lane's partial dot is warp-reduced with __shfl_xor_sync and
//   written by lane 0.
// * Identity mode: kUnroll edges a step, their table-row loads (dw)
//   issued before any is used, so several are in flight; their dfeats
//   stores likewise go out back to back.  An edge of weight 0 writes +0
//   without reading g into it, as the general mode leaves its row
//   (zero-filled, no atomics): only a non-finite g differs from a plain
//   product there, as in the reverse-index kernel.  Every output goes
//   out by streaming stores (common.cuh's store_vec, st.global.cs,
//   evict-first), which at mini-batch layer 2 reached 85 % of the bound
//   where plain stores reached 66 % (PERF.md section 6).
// * General mode: dfeats by Hopper's vector reductions, atomicAdd(float4)
//   / (float2) (red.global.add.v4.f32, sm_90, global memory) on the
//   lane's V contiguous f32 columns, scalar atomics only where V = 1.
//   Atomics land in no fixed order, so dfeats is deterministic only where
//   no two edges share a row.  Edges of weight 0 send no atomics: the ELL
//   layout points all its padding edges at row 0, whose atomics would
//   otherwise serialise.  An id outside [0, N) sends no atomics and sets
//   its dw[b, k] to NaN, like the forward's poisoned row.
// * dfeats or dw is skipped entirely when its pointer is null (autograd
//   did not ask for it), and so are dself and dw_self.
// * Ragged B, K and D are masked, never padded; rows use 64-bit offsets.

#include "common.cuh"

namespace {

using nagg::from_f32;
using nagg::kFull;
using nagg::kPassCols;
using nagg::kWarp;
using nagg::load_vec;
using nagg::store_vec;
using nagg::to_f32;
using nagg::warp_sum;

constexpr int kRowsPerBlock = 8;  // warps per block, one output row each
constexpr int kUnroll = 4;        // identity mode: edges a step

// g's columns [c0, c0 + kPassCols) of a row in this lane's layout
// (zeros past D)
template <typename T, int V>
__device__ __forceinline__ void load_pass(float* gr, const T* row, int c0,
                                          int lane, int d_total) {
  constexpr int kCh = kPassCols / (kWarp * V);
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int d = c0 + c * kWarp * V + lane * V;
    if (d < d_total) {
      load_vec<T, V>(row + d, gr + c * V);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) gr[c * V + i] = 0.f;
    }
  }
}

// dot += <gr, row's pass at c0> in this lane's columns, one __fmaf_rn
// chain in column order (the one chain both modes take)
template <typename T, int V>
__device__ __forceinline__ float dot_pass(float dot, const float* gr,
                                          const float* x) {
  constexpr int kCh = kPassCols / (kWarp * V);
#pragma unroll
  for (int j = 0; j < kCh * V; ++j) dot = __fmaf_rn(gr[j], x[j], dot);
  return dot;
}

// the fused self terms of row b: dself = w_self * g and dw_self = <g,
// self_rows>; gr holds g's pass 0 on entry and on exit
template <typename T, int V>
__device__ __forceinline__ void self_terms(float* gr, const T* g_row,
                                           const T* s_row, float ws,
                                           T* dself_row, T* dw_self_b,
                                           int lane, int d_total) {
  constexpr int kCh = kPassCols / (kWarp * V);
  float dot = 0.f;
  for (int c0 = 0; c0 < d_total; c0 += kPassCols) {
    if (c0 > 0) load_pass<T, V>(gr, g_row, c0, lane, d_total);
    float x[kCh * V];
    load_pass<T, V>(x, s_row, c0, lane, d_total);
    dot = dot_pass<T, V>(dot, gr, x);
    if (dself_row != nullptr) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const int d = c0 + c * kWarp * V + lane * V;
        if (d < d_total) {
          float v[V];
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = __fmul_rn(ws, gr[c * V + i]);
          store_vec<T, V>(dself_row + d, v);
        }
      }
    }
  }
  dot = warp_sum(dot);
  if (lane == 0 && dw_self_b != nullptr) *dw_self_b = from_f32<T>(dot);
  if (d_total > kPassCols) load_pass<T, V>(gr, g_row, 0, lane, d_total);
}

// V f32 values added to dfeats at p (aligned to min(4V, 16) bytes) by
// the widest vector reductions that fit
template <int V>
__device__ __forceinline__ void red_add(float* p, const float* v) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + q),
                make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
    }
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// ---- general mode ---------------------------------------------------------

template <typename T, int V, bool FUSED>
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
  constexpr int kCh = kPassCols / (kWarp * V);
  const int lane = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (b >= b_total) return;  // whole warp: b is uniform across lanes
  const bool one_pass = d_total <= kPassCols;
  const T* g_row = g + b * d_total;

  float gr[kCh * V];
  load_pass<T, V>(gr, g_row, 0, lane, d_total);

  if (FUSED && (dself != nullptr || dw_self != nullptr)) {
    self_terms<T, V>(gr, g_row, self_rows + b * d_total, to_f32(w_self[b]),
                     dself == nullptr ? nullptr : dself + b * d_total,
                     dw_self == nullptr ? nullptr : dw_self + b, lane,
                     d_total);
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
      for (int c0 = 0; c0 < d_total; c0 += kPassCols) {
        if (c0 > 0) load_pass<T, V>(gr, g_row, c0, lane, d_total);
        if (bad) continue;
        if (dw != nullptr) {
          float x[kCh * V];
          load_pass<T, V>(x, feats + row_off, c0, lane, d_total);
          dot = dot_pass<T, V>(dot, gr, x);
        }
        if (scatter) {
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const int d = c0 + c * kWarp * V + lane * V;
            if (d < d_total) {
              float v[V];
#pragma unroll
              for (int i = 0; i < V; ++i) v[i] = __fmul_rn(wk, gr[c * V + i]);
              red_add<V>(dfeats + row_off + d, v);
            }
          }
        }
      }
      if (!one_pass) load_pass<T, V>(gr, g_row, 0, lane, d_total);
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

// ---- identity mode --------------------------------------------------------

// DW: dw asked for (its table-row loads need registers that the
// dfeats-only launch of the mini-batch path leaves to occupancy)
template <typename T, int V, bool FUSED, bool DW>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
    neighbor_agg_bwd_identity_kernel(const T* __restrict__ table,
                                     const T* __restrict__ w,
                                     const T* __restrict__ g,
                                     const T* __restrict__ self_rows,
                                     const T* __restrict__ w_self,
                                     T* __restrict__ dfeats,
                                     T* __restrict__ dw,
                                     T* __restrict__ dself,
                                     T* __restrict__ dw_self,
                                     int64_t b_total, int k_total,
                                     int d_total) {
  constexpr int kCh = kPassCols / (kWarp * V);
  const int lane = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (b >= b_total) return;  // whole warp: b is uniform across lanes
  const bool one_pass = d_total <= kPassCols;
  const T* g_row = g + b * d_total;

  float gr[kCh * V];
  load_pass<T, V>(gr, g_row, 0, lane, d_total);

  if (FUSED && (dself != nullptr || dw_self != nullptr)) {
    self_terms<T, V>(gr, g_row, self_rows + b * d_total, to_f32(w_self[b]),
                     dself == nullptr ? nullptr : dself + b * d_total,
                     dw_self == nullptr ? nullptr : dw_self + b, lane,
                     d_total);
  }

  if (dfeats == nullptr && !DW) return;
  const T* w_row = w + b * k_total;
  const int64_t e_row = b * k_total;  // edge (and table row) of k = 0
  for (int k0 = 0; k0 < k_total; k0 += kWarp) {
    const int kk = k0 + lane;
    const float my_w = kk < k_total ? to_f32(w_row[kk]) : 0.f;
    const int kn = min(kWarp, k_total - k0);
    for (int t0 = 0; t0 < kn; t0 += kUnroll) {
      const int nu = min(kUnroll, kn - t0);
      float wk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        wk[u] = __shfl_sync(kFull, my_w, (t0 + u) & (kWarp - 1));
      }
      float dot[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dot[u] = 0.f;
      for (int c0 = 0; c0 < d_total; c0 += kPassCols) {
        if (!one_pass) load_pass<T, V>(gr, g_row, c0, lane, d_total);
        if (dfeats != nullptr) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            T* out_row = dfeats + (e_row + k0 + t0 + u) * d_total;
#pragma unroll
            for (int c = 0; c < kCh; ++c) {
              const int d = c0 + c * kWarp * V + lane * V;
              if (u < nu && d < d_total) {
                float v[V];
#pragma unroll
                for (int i = 0; i < V; ++i) {
                  v[i] = wk[u] != 0.f ? __fmul_rn(wk[u], gr[c * V + i])
                                      : 0.f;
                }
                store_vec<T, V>(out_row + d, v);
              }
            }
          }
        }
        if constexpr (DW) {
          float x[kUnroll][kCh * V];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {  // every load first ...
            if (u < nu) {
              load_pass<T, V>(x[u], table + (e_row + k0 + t0 + u) * d_total,
                              c0, lane, d_total);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {  // ... then the chains
            if (u < nu) dot[u] = dot_pass<T, V>(dot[u], gr, x[u]);
          }
        }
      }
      if constexpr (DW) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float s = warp_sum(dot[u]);
          if (lane == 0 && u < nu) dw[e_row + k0 + t0 + u] = from_f32<T>(s);
        }
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

dim3 grid_of(int64_t b) {
  return dim3((unsigned)((b + kRowsPerBlock - 1) / kRowsPerBlock));
}

template <typename T, int V>
void launch_v(const void* feats, const void* idx, const void* w,
              const void* g, const void* self_rows, const void* w_self,
              void* dfeats, void* dw, void* dself, void* dw_self, int64_t n,
              int64_t b, int k, int d, cudaStream_t stream) {
  const dim3 block(kWarp, kRowsPerBlock);
  const T* f = static_cast<const T*>(feats);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* ww = static_cast<const T*>(w);
  const T* gg = static_cast<const T*>(g);
  float* df = static_cast<float*>(dfeats);
  T* dww = static_cast<T*>(dw);
  if (self_rows != nullptr) {
    neighbor_agg_bwd_kernel<T, V, true><<<grid_of(b), block, 0, stream>>>(
        f, i, ww, gg, static_cast<const T*>(self_rows),
        static_cast<const T*>(w_self), df, dww, static_cast<T*>(dself),
        static_cast<T*>(dw_self), n, b, k, d);
  } else {
    neighbor_agg_bwd_kernel<T, V, false><<<grid_of(b), block, 0, stream>>>(
        f, i, ww, gg, nullptr, nullptr, df, dww, nullptr, nullptr, n, b, k,
        d);
  }
}

template <typename T, int V, bool DW>
void launch_identity_dw(const void* table, const void* w, const void* g,
                        const void* self_rows, const void* w_self,
                        void* dfeats, void* dw, void* dself, void* dw_self,
                        int64_t b, int k, int d, cudaStream_t stream) {
  const dim3 block(kWarp, kRowsPerBlock);
  const T* t = static_cast<const T*>(table);
  const T* ww = static_cast<const T*>(w);
  const T* gg = static_cast<const T*>(g);
  T* df = static_cast<T*>(dfeats);
  T* dww = static_cast<T*>(dw);
  if (self_rows != nullptr) {
    neighbor_agg_bwd_identity_kernel<T, V, true, DW>
        <<<grid_of(b), block, 0, stream>>>(
            t, ww, gg, static_cast<const T*>(self_rows),
            static_cast<const T*>(w_self), df, dww, static_cast<T*>(dself),
            static_cast<T*>(dw_self), b, k, d);
  } else {
    neighbor_agg_bwd_identity_kernel<T, V, false, DW>
        <<<grid_of(b), block, 0, stream>>>(t, ww, gg, nullptr, nullptr, df,
                                           dww, nullptr, nullptr, b, k, d);
  }
}

template <typename T, int V>
void launch_identity_v(const void* table, const void* w, const void* g,
                       const void* self_rows, const void* w_self,
                       void* dfeats, void* dw, void* dself, void* dw_self,
                       int64_t b, int k, int d, cudaStream_t stream) {
  if (dw != nullptr) {
    launch_identity_dw<T, V, true>(table, w, g, self_rows, w_self, dfeats,
                                   dw, dself, dw_self, b, k, d, stream);
  } else {
    launch_identity_dw<T, V, false>(table, w, g, self_rows, w_self, dfeats,
                                    dw, dself, dw_self, b, k, d, stream);
  }
}

// V for a launch: the widest D and every T operand allow (the f32
// dfeats of the general mode aligned for its vector reductions)
template <typename T>
int width_of(int d, const void* rows, const void* g, const void* self_rows,
             const void* dself, const void* t_out, const void* f32_out) {
  const void* ptrs[] = {rows, g, self_rows, dself, t_out};
  return nagg::lane_width((int)sizeof(T), d, ptrs, 5, f32_out);
}

template <typename T>
void launch(const void* feats, const void* idx, const void* w,
            const void* g, const void* self_rows, const void* w_self,
            void* dfeats, void* dw, void* dself, void* dw_self, int64_t n,
            int64_t b, int k, int d, cudaStream_t stream) {
  switch (width_of<T>(d, feats, g, self_rows, dself, nullptr, dfeats)) {
#define NAB_CASE(VV)                                                       \
  case VV:                                                                 \
    launch_v<T, (VV * sizeof(T) <= 16 ? VV : 1)>(                          \
        feats, idx, w, g, self_rows, w_self, dfeats, dw, dself, dw_self,   \
        n, b, k, d, stream);                                               \
    break;
    NAB_CASE(2)
    NAB_CASE(4)
    NAB_CASE(8)
#undef NAB_CASE
    default:
      launch_v<T, 1>(feats, idx, w, g, self_rows, w_self, dfeats, dw, dself,
                     dw_self, n, b, k, d, stream);
  }
}

template <typename T>
void launch_identity(const void* table, const void* w, const void* g,
                     const void* self_rows, const void* w_self,
                     void* dfeats, void* dw, void* dself, void* dw_self,
                     int64_t b, int k, int d, cudaStream_t stream) {
  switch (width_of<T>(d, table, g, self_rows, dself, dfeats, nullptr)) {
#define NABI_CASE(VV)                                                      \
  case VV:                                                                 \
    launch_identity_v<T, (VV * sizeof(T) <= 16 ? VV : 1)>(                 \
        table, w, g, self_rows, w_self, dfeats, dw, dself, dw_self, b, k,  \
        d, stream);                                                        \
    break;
    NABI_CASE(2)
    NABI_CASE(4)
    NABI_CASE(8)
#undef NABI_CASE
    default:
      launch_identity_v<T, 1>(table, w, g, self_rows, w_self, dfeats, dw,
                              dself, dw_self, b, k, d, stream);
  }
}

int check_args(long long b, int k, int d, const void* self_rows,
               const void* w_self, const void* dself, const void* dw_self) {
  if (b <= 0 || d <= 0 || k < 0) return nagg::kBadArgs;
  if ((self_rows == nullptr) != (w_self == nullptr)) return nagg::kBadArgs;
  if (self_rows == nullptr && (dself != nullptr || dw_self != nullptr)) {
    return nagg::kBadArgs;
  }
  if ((b + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL) {
    return nagg::kBadArgs;
  }
  return 0;
}

}  // namespace

// Plain C entry points, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  self_rows/w_self both null (plain) or both set (fused);
// any output may be null (not computed).  Each returns the cudaError_t of
// the launch (0 = launched), 1000 for an unknown dtype or bad arguments;
// launches on `stream`, never syncs.

// General mode: dfeats is an f32 [n, d] buffer the caller zeroes.
extern "C" int neighbor_agg_backward(int dtype, const void* feats,
                                     const void* idx, const void* w,
                                     const void* g, const void* self_rows,
                                     const void* w_self, void* dfeats,
                                     void* dw, void* dself, void* dw_self,
                                     long long n, long long b, int k, int d,
                                     void* stream) {
  if (n < 0) return nagg::kBadArgs;
  if (int err = check_args(b, k, d, self_rows, w_self, dself, dw_self)) {
    return err;
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

// Identity mode: table [b*k, d] (read for dw only), dfeats [b*k, d] in
// table's dtype, every row written (the caller need not zero it).
extern "C" int neighbor_agg_backward_identity(
    int dtype, const void* table, const void* w, const void* g,
    const void* self_rows, const void* w_self, void* dfeats, void* dw,
    void* dself, void* dw_self, long long b, int k, int d, void* stream) {
  if (int err = check_args(b, k, d, self_rows, w_self, dself, dw_self)) {
    return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_identity<float>(table, w, g, self_rows, w_self, dfeats, dw,
                           dself, dw_self, b, k, d, s);
  } else if (dtype == 1) {
    launch_identity<__nv_bfloat16>(table, w, g, self_rows, w_self, dfeats,
                                   dw, dself, dw_self, b, k, d, s);
  } else {
    return nagg::kBadArgs;
  }
  return static_cast<int>(cudaGetLastError());
}
