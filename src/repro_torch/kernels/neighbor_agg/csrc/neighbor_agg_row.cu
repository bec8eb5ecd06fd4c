// Row kernel of the weighted neighbor aggregation for Hopper, sm_90a:
//
//   out[b, :] = sum_k w[b, k] * feats[idx[b, k], :]
//
// feats [N, D] f32 or bf16; idx [B, K] int32; w [B, K] in feats' dtype;
// out [B, D] in feats' dtype.  Products and the sum are taken in f32 and
// rounded to the output dtype once.  No fused epilogue: the caller adds
// a self term outside, as the reference's "row" dispatch does.
//
// Replaces the TPU kernel neighbor_agg_pallas, the seed row kernel
// (src/repro/kernels/neighbor_agg/neighbor_agg.py:85, pallas_call at
// :114, body _row_kernel :68-82): one (1, d_tile) output row tile per
// grid step over the grid (B, D/d_tile, K), the K axis sequential with an
// f32 scratch accumulator.
//
// What bounds it: bytes, as for the tiled kernel (same work, same bound:
// the distinct feature rows referenced, idx, w and out, each once, over
// the 3.35 TB/s of HBM).  Its realistic floor at random ids is the
// gather's line traffic: every (b, k) edge reads its row's L2 lines.
//
// What the design does about it: the direct route's design, from the
// same device code (common.cuh's gather_pass), as a kernel symbol of its
// own without the fused epilogue.
// * One warp per output row b (8 rows a block), the row's ids and
//   weights read once with one coalesced 32-wide load and broadcast with
//   __shfl_sync (the TPU grid's sequential K axis becomes the loop).
// * Lanes along D in V-wide vectors (common.cuh: 16-byte loads wherever
//   D and the pointers allow, 8-, 4- or 2-byte ones elsewhere), up to 256
//   columns a block; wider rows take more block columns.
// * K unrolled: the rows of several edges are loaded, as raw words,
//   before any is added, so their loads are in flight together.
// * The f32 chain is pinned as in the direct route (neighbor_agg.cu):
//   one __fmaf_rn per edge in k order from 0, so the two kernels are
//   bit-equal on the same inputs.
// * Ragged B, K and D are masked, never padded; rows use 64-bit offsets.
//   An id outside [0, N) reads nothing and poisons its output row with
//   NaN, as the tiled kernel does.

#include "common.cuh"

namespace {

using nagg::kPassCols;
using nagg::kWarp;
using nagg::store_vec;

constexpr int kRowsPerBlock = 8;  // warps per block, one output row each

template <typename T, int V, int CH>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
    neighbor_agg_row_kernel(const T* __restrict__ feats,
                            const int32_t* __restrict__ idx,
                            const T* __restrict__ w, T* __restrict__ out,
                            int64_t n, int64_t b_total, int k_total,
                            int d_total) {
  constexpr int kCh = CH;  // V-chunks a lane holds
  const int lane = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (b >= b_total) return;  // whole warp: b is uniform across lanes
  const int c0 = blockIdx.y * (kCh * kWarp * V);

  float acc[kCh * V];
#pragma unroll
  for (int j = 0; j < kCh * V; ++j) acc[j] = 0.f;
  const bool bad = nagg::gather_pass<T, V, CH>(
      acc, feats, idx + b * k_total, w + b * k_total, n, k_total, d_total,
      c0, lane);

  T* out_row = out + b * d_total;
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int d = c0 + c * kWarp * V + lane * V;
    if (d < d_total) {
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        v[i] = bad ? nagg::quiet_nan() : acc[c * V + i];
      }
      store_vec<T, V>(out_row + d, v);
    }
  }
}

template <typename T, int V, int CH>
void launch_vc(const void* feats, const void* idx, const void* w, void* out,
               int64_t n, int64_t b, int k, int d, cudaStream_t stream) {
  const dim3 block(kWarp, kRowsPerBlock);
  const int pass = CH * kWarp * V;
  const dim3 grid((unsigned)((b + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)((d + pass - 1) / pass));
  neighbor_agg_row_kernel<T, V, CH><<<grid, block, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(idx),
      static_cast<const T*>(w), static_cast<T*>(out), n, b, k, d);
}

template <typename T>
void launch(const void* feats, const void* idx, const void* w, void* out,
            int64_t n, int64_t b, int k, int d, cudaStream_t stream) {
  const void* ptrs[] = {feats, out};
  nagg::with_layout<(int)sizeof(T)>(d, ptrs, 2, [&](auto v, auto ch) {
    launch_vc<T, decltype(v)::value, decltype(ch)::value>(
        feats, idx, w, out, n, b, k, d, stream);
  });
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launch (0 = launched);
// 1000 for an unknown dtype or bad arguments.  Launches on `stream`,
// never syncs.
extern "C" int neighbor_agg_row_forward(int dtype, const void* feats,
                                        const void* idx, const void* w,
                                        void* out, long long n, long long b,
                                        int k, int d, void* stream) {
  if (b <= 0 || d <= 0 || k < 0 || n < 0) return nagg::kBadArgs;
  if ((b + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL ||
      (d + kPassCols - 1) / kPassCols > 65535) {
    return nagg::kBadArgs;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(feats, idx, w, out, n, b, k, d, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(feats, idx, w, out, n, b, k, d, s);
  } else {
    return nagg::kBadArgs;
  }
  return static_cast<int>(cudaGetLastError());
}
