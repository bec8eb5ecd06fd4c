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
// the 3.35 TB/s of HBM).
//
// What the design does about it: it keeps the seed's shape on purpose.
// * One block of 128 threads per (b, 128-column tile); each thread owns
//   one column and walks K in order with an f32 accumulator in a
//   register (the TPU grid's sequential K axis becomes the loop).
// * The id and weight of step k are one address for the whole block, so
//   each load is a broadcast; the row read is one coalesced 128-wide
//   segment per block.
// * D is masked in the kernel instead of padded to d_tile (the reference
//   pads it in ops.py:198); B and K need no mask (one block per row).
// * Rows use 64-bit offsets; an id outside [0, N) reads nothing and
//   poisons its output row with NaN, as the tiled kernel does.
// It loads each row's ids once per column tile instead of once per row
// and keeps no loads in flight across k: the tiled kernel is the fast one.

#include "common.cuh"

namespace {

using nagg::from_f32;
using nagg::to_f32;

constexpr int kCols = 128;  // the reference's default d_tile

template <typename T>
__global__ void __launch_bounds__(kCols)
    neighbor_agg_row_kernel(const T* __restrict__ feats,
                            const int32_t* __restrict__ idx,
                            const T* __restrict__ w, T* __restrict__ out,
                            int64_t n, int k_total, int d_total) {
  const int64_t b = blockIdx.x;
  const int d = blockIdx.y * kCols + threadIdx.x;
  const int32_t* idx_row = idx + b * k_total;
  const T* w_row = w + b * k_total;
  float acc = 0.f;
  bool bad = false;
  for (int k = 0; k < k_total; ++k) {
    const int32_t nid = idx_row[k];  // one address for the whole block
    const float wk = to_f32(w_row[k]);
    if (nid < 0 || (int64_t)nid >= n) {
      bad = true;
      continue;
    }
    if (d < d_total) acc += wk * to_f32(feats[(int64_t)nid * d_total + d]);
  }
  if (d < d_total) {
    out[b * d_total + d] = from_f32<T>(bad ? nagg::quiet_nan() : acc);
  }
}

template <typename T>
void launch(const void* feats, const void* idx, const void* w, void* out,
            int64_t n, int64_t b, int k, int d, cudaStream_t stream) {
  const dim3 grid((unsigned)b, (unsigned)((d + kCols - 1) / kCols));
  neighbor_agg_row_kernel<T><<<grid, kCols, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(idx),
      static_cast<const T*>(w), static_cast<T*>(out), n, k, d);
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
  if (b > 0x7fffffffLL || (d + kCols - 1) / kCols > 65535) {
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
