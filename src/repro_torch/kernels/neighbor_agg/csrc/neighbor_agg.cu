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
// * One warp per output row, 8 rows a block, lanes along D in V-wide
//   vectors (common.cuh: 16-byte loads wherever D and the pointers
//   allow, 8-, 4- or 2-byte ones elsewhere; bf16 D = 172 has 344-byte
//   rows, 8-byte aligned, so V = 4), a lane holding the fewest V-chunks
//   that cover the row (a 256-column block column at most; wider rows
//   take more block columns).  Each gathered feature row is read by
//   coalesced warp loads and never twice by a block.
// * The gather is common.cuh's gather_pass, shared with the row kernel
//   (neighbor_agg_row.cu): the block's ids and weights come in as one
//   coalesced 32-wide load per warp and are broadcast with __shfl_sync
//   (the TPU kernel needs scalar prefetch for this; here a block loads
//   its own), and the rows of several edges are loaded, as raw words,
//   before any is added, so their loads are in flight together.  The f32
//   accumulator stays in registers.
// * Ragged B, K and D are masked in the kernel, never padded: no copy
//   of feats is made.  Rows use 64-bit offsets (idx * D overflows int32
//   at 16.7M nodes x 256).  Zero-weight edges are computed like any
//   other (0 * x == 0 exactly for finite x), matching the reference.
// * An id outside [0, N) reads nothing and poisons its output row with
//   NaN instead of reading stray memory.
// * The arithmetic is pinned with __fmul_rn / __fmaf_rn (the fused
//   init is one rounded product, each edge one fused multiply-add, in k
//   order): the slab route (neighbor_agg_slab.cu) and the row kernel take
//   the same chain, so the three are bit-equal whatever the compiler
//   contracts.
// * The output goes out by streaming stores (st.global.cs), as the slab
//   route's does.

#include "common.cuh"

namespace {

using nagg::kPassCols;
using nagg::kWarp;
using nagg::load_vec;
using nagg::store_vec;
using nagg::to_f32;

constexpr int kRowsPerBlock = 8;  // warps per block, one output row each

template <typename T, typename O, int V, int CH, bool FUSED>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
    neighbor_agg_kernel(const T* __restrict__ feats,
                        const int32_t* __restrict__ idx,
                        const T* __restrict__ w,
                        const O* __restrict__ self_rows,
                        const O* __restrict__ w_self, O* __restrict__ out,
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
  if (FUSED) {
    const float ws = to_f32(w_self[b]);
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int d = c0 + c * kWarp * V + lane * V;
      if (d < d_total) {
        float s[V];
        load_vec<O, V>(self_rows + b * d_total + d, s);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[c * V + i] = __fmul_rn(ws, s[i]);
      }
    }
  }

  const bool bad = nagg::gather_pass<T, V, CH>(
      acc, feats, idx + b * k_total, w + b * k_total, n, k_total, d_total,
      c0, lane);

  O* out_row = out + b * d_total;
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int d = c0 + c * kWarp * V + lane * V;
    if (d < d_total) {
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        v[i] = bad ? nagg::quiet_nan() : acc[c * V + i];
      }
      store_vec<O, V>(out_row + d, v);
    }
  }
}

template <typename T, typename O, int V, int CH>
void launch_vc(const void* feats, const void* idx, const void* w,
               const void* self_rows, const void* w_self, void* out,
               int64_t n, int64_t b, int k, int d, cudaStream_t stream) {
  const dim3 block(kWarp, kRowsPerBlock);
  const int pass = CH * kWarp * V;
  const dim3 grid((unsigned)((b + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)((d + pass - 1) / pass));
  const T* f = static_cast<const T*>(feats);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* ww = static_cast<const T*>(w);
  O* o = static_cast<O*>(out);
  if (self_rows != nullptr) {
    neighbor_agg_kernel<T, O, V, CH, true><<<grid, block, 0, stream>>>(
        f, i, ww, static_cast<const O*>(self_rows),
        static_cast<const O*>(w_self), o, n, b, k, d);
  } else {
    neighbor_agg_kernel<T, O, V, CH, false><<<grid, block, 0, stream>>>(
        f, i, ww, nullptr, nullptr, o, n, b, k, d);
  }
}

template <typename T, typename O>
void launch(const void* feats, const void* idx, const void* w,
            const void* self_rows, const void* w_self, void* out, int64_t n,
            int64_t b, int k, int d, cudaStream_t stream) {
  // V from the wider of the two dtypes, so an f32 self_rows / out of a
  // bf16 table still moves at most 16 bytes a lane
  constexpr int kEl = sizeof(O) > sizeof(T) ? sizeof(O) : sizeof(T);
  const void* ptrs[] = {feats, self_rows, out};
  nagg::with_layout<kEl>(d, ptrs, 3, [&](auto v, auto ch) {
    launch_vc<T, O, decltype(v)::value, decltype(ch)::value>(
        feats, idx, w, self_rows, w_self, out, n, b, k, d, stream);
  });
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
  if (b <= 0 || d <= 0 || k < 0 || n < 0) return nagg::kBadArgs;
  if ((self_rows == nullptr) != (w_self == nullptr)) return nagg::kBadArgs;
  if ((b + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL ||
      (d + kPassCols - 1) / kPassCols > 65535) {
    return nagg::kBadArgs;
  }
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
    return nagg::kBadArgs;
  }
  return static_cast<int>(cudaGetLastError());
}
