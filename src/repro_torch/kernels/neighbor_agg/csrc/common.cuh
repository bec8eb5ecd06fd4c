// Shared helpers of the neighbor-aggregation kernels (forward, backward,
// row): f32 <-> storage-type conversions, a warp sum, and V-wide vector
// loads and stores along a row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace nagg {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// error code returned by the C entry points for arguments they refuse
constexpr int kBadArgs = 1000;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;  // every lane holds the sum
}

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

// ---- V-wide lanes: V consecutive elements of a row moved as one load or
// store of V * sizeof(T) bytes (2, 4, 8 or 16), the address aligned to
// that size.  A warp pass covers CH * 32 * V columns, at most kPassCols:
// lane l owns, in chunk c < CH, the columns c * 32 * V + l * V + [0, V).

constexpr int kPassCols = 256;

// the widest V (elements) that D and every base pointer allow, but no
// wider than 32 lanes need to cover D (so a narrow row keeps every lane
// busy): V * el <= 16, D % V == 0 (so every row starts aligned) and each
// pointer (null ones aside) aligned to V * el bytes; f32_ptr (may be
// null) is an f32 array of the same row layout, aligned to min(4 * V, 16)
// bytes
inline int lane_width(int el, int d, const void* const* ptrs, int n_ptrs,
                      const void* f32_ptr = nullptr) {
  int widest = 1;
  while (widest * kWarp < d && widest < 16 / el) widest *= 2;
  for (int v = widest; v > 1; v /= 2) {
    if (d % v != 0) continue;
    bool ok = f32_ptr == nullptr ||
              reinterpret_cast<uintptr_t>(f32_ptr) % (4 * v < 16 ? 4 * v
                                                                  : 16) == 0;
    for (int i = 0; i < n_ptrs && ok; ++i) {
      ok = reinterpret_cast<uintptr_t>(ptrs[i]) % (v * el) == 0;
    }
    if (ok) return v;
  }
  return 1;
}

// raw bits of V elements as 32-bit words (bf16: two a word, low first)
template <typename T, int V>
struct Words {
  static constexpr int kBytes = V * (int)sizeof(T);
  static constexpr int kN = kBytes >= 4 ? kBytes / 4 : 1;
};

template <typename T, int V>
__device__ __forceinline__ void load_words(const T* p,
                                           uint32_t (&wd)[Words<T, V>::kN]) {
  constexpr int kBytes = Words<T, V>::kBytes;
  if constexpr (kBytes == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    wd[0] = r.x; wd[1] = r.y; wd[2] = r.z; wd[3] = r.w;
  } else if constexpr (kBytes == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    wd[0] = r.x; wd[1] = r.y;
  } else if constexpr (kBytes == 4) {
    wd[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    wd[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// the V elements of load_words' words as f32 (exact)
template <typename T, int V>
__device__ __forceinline__ void unpack_words(
    const uint32_t (&wd)[Words<T, V>::kN], float* out) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = __uint_as_float(wd[i]);
  } else if constexpr (V == 1) {
    out[0] = __uint_as_float(wd[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      out[2 * i] = __uint_as_float(wd[i] << 16);
      out[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
    }
  }
}

// V elements at p (read-only for the kernel's lifetime) into f32
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  uint32_t wd[Words<T, V>::kN];
  load_words<T, V>(p, wd);
  unpack_words<T, V>(wd, out);
}

// V f32 values rounded once to T and stored at p by a streaming store
// (st.global.cs, evict-first): every output here is written once and
// read back by another launch, if at all
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  constexpr int kBytes = Words<T, V>::kBytes;
  uint32_t wd[Words<T, V>::kN];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < V; ++i) wd[i] = __float_as_uint(in[i]);
  } else if constexpr (V == 1) {
    wd[0] = __bfloat16_as_ushort(__float2bfloat16(in[0]));
  } else {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      wd[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(in[2 * i])) |
              ((uint32_t)__bfloat16_as_ushort(
                   __float2bfloat16(in[2 * i + 1])) << 16);
    }
  }
  if constexpr (kBytes == 16) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(wd[0], wd[1], wd[2],
                                                   wd[3]));
  } else if constexpr (kBytes == 8) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(wd[0], wd[1]));
  } else if constexpr (kBytes == 4) {
    __stcs(reinterpret_cast<unsigned int*>(p), wd[0]);
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)wd[0]);
  }
}

// ---- the gather of the forward kernels (the tiled forward's direct
// route and the row kernel): one warp per output row, one pass of
// CH * 32 * V columns from c0 (CH V-chunks a lane, pass_chunks).
//
//   acc[j] = __fmaf_rn(w[k], feats[idx[k], col j], acc[j])   k = 0, 1, ...
//
// in this lane's V-chunk layout (acc holds the CH * V columns the lane
// owns, zeros or a fused self term on entry).  The row's ids and weights
// come in 32 at a time, one coalesced load a lane, and are broadcast with
// __shfl_sync.  The rows of kUnroll edges are loaded as raw words before
// any is added, so their loads are in flight together: up to kRowWords
// registers of row data a lane and kMaxUnroll edges (a row narrower than
// a pass holds fewer chunks, so fewer registers), widened to f32 only as
// each is added, in k order.  An id outside
// [0, N) reads nothing; the return value says whether the row had one.

constexpr int kRowWords = 32;  // registers of row data in flight a lane
constexpr int kMaxUnroll = 8;  // edges in flight (their ids and weights)

// the V-chunks a lane holds in one pass over a row of d columns: the
// fewest (a power of 2) that cover d, at most a kPassCols-wide pass
inline int pass_chunks(int d, int v) {
  const int most = kPassCols / (kWarp * v);
  int ch = 1;
  while (ch < most && ch * kWarp * v < d) ch *= 2;
  return ch;
}

template <int V, typename F>
void with_chunks(int ch, F& f) {
  constexpr int kMost = kPassCols / (kWarp * V);
  using VV = std::integral_constant<int, V>;
  if constexpr (kMost >= 8) {
    if (ch == 8) return f(VV{}, std::integral_constant<int, 8>{});
  }
  if constexpr (kMost >= 4) {
    if (ch == 4) return f(VV{}, std::integral_constant<int, 4>{});
  }
  if constexpr (kMost >= 2) {
    if (ch == 2) return f(VV{}, std::integral_constant<int, 2>{});
  }
  f(VV{}, std::integral_constant<int, 1>{});
}

// f(V, CH) with the lane width V (lane_width, elements of at most EL
// bytes) and the chunks CH (pass_chunks) as integral constants
template <int EL, typename F>
void with_layout(int d, const void* const* ptrs, int n_ptrs, F&& f) {
  const int v = lane_width(EL, d, ptrs, n_ptrs);
  if constexpr (EL <= 2) {
    if (v == 8) return with_chunks<8>(pass_chunks(d, 8), f);
  }
  if (v == 4) return with_chunks<4>(pass_chunks(d, 4), f);
  if (v == 2) return with_chunks<2>(pass_chunks(d, 2), f);
  with_chunks<1>(pass_chunks(d, 1), f);
}

template <typename T, int V, int CH>
__device__ __forceinline__ bool gather_pass(
    float* acc, const T* __restrict__ feats, const int32_t* idx_row,
    const T* w_row, int64_t n, int k_total, int d_total, int c0, int lane) {
  constexpr int kCh = CH;
  constexpr int kW = Words<T, V>::kN;  // words of one V-chunk
  constexpr int kFit = kRowWords / (kCh * kW);
  constexpr int kUnroll = kFit < kMaxUnroll ? kFit : kMaxUnroll;  // edges
  bool bad = false;
  for (int k0 = 0; k0 < k_total; k0 += kWarp) {
    const int kk = k0 + lane;
    int32_t my_id = 0;
    float my_w = 0.f;
    if (kk < k_total) {
      my_id = idx_row[kk];
      my_w = to_f32(w_row[kk]);
    }
    const int kn = min(kWarp, k_total - k0);
    for (int t0 = 0; t0 < kn; t0 += kUnroll) {
      int32_t nid[kUnroll];
      float wk[kUnroll];
      bool use[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // warp-uniform
        nid[u] = __shfl_sync(kFull, my_id, (t0 + u) & (kWarp - 1));
        wk[u] = __shfl_sync(kFull, my_w, (t0 + u) & (kWarp - 1));
        const bool in_k = t0 + u < kn;
        const bool ok = nid[u] >= 0 && (int64_t)nid[u] < n;
        bad |= in_k && !ok;
        use[u] = in_k && ok;
      }
      uint32_t raw[kUnroll][kCh][kW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // every row load first ...
        const T* row = feats + (int64_t)nid[u] * d_total;  // 64-bit
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          const int d = c0 + c * kWarp * V + lane * V;
          if (use[u] && d < d_total) {
            load_words<T, V>(row + d, raw[u][c]);
          } else {
#pragma unroll
            for (int i = 0; i < kW; ++i) raw[u][c][i] = 0u;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // ... then the sums, in k order
        if (use[u]) {
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            float x[V];
            unpack_words<T, V>(raw[u][c], x);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              acc[c * V + i] = __fmaf_rn(wk[u], x[i], acc[c * V + i]);
            }
          }
        }
      }
    }
  }
  return bad;
}

}  // namespace nagg
