// Causal, optionally sliding-window, flash attention for Hopper, sm_90a:
//
//   o[b, s, h, :] = sum_t softmax_t(mask(q[b,s,h,:] . k[b,t,h/g,:] / sqrt(D)))
//                   * v[b, t, h/g, :]
//
// q, o [B, S, Hq, D] and k, v [B, S, Hkv, D], f32 or bf16, contiguous and
// 16-byte aligned, read and written in place (no transposes, no repeat of the KV heads:
// query head h reads KV head h / (Hq / Hkv)).  The mask keeps t <= s and,
// with window > 0, t > s - window.  Every product and sum is taken in
// f32; the output is rounded to the input dtype once, at the store.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/flash_attn.py:78, pallas_call at :96,
// body _kernel :30-75) and the GQA repeat and [B,S,H,D] <-> [B,H,S,D]
// moves of its wrapper (flash_attn/ops.py:23-31).
//
// What bounds it: operations.  At the prefill shapes of gemma3-12b
// (S = 4096, D = 256) each (query, key) pair kept costs 4*D flops against
// q, k, v and o read or written once (~0.2 GB for B = 2, Hq = 16): some
// 1,400 flops a byte, far above the card's balance point.  This kernel
// does its products with f32 FMAs on the CUDA cores (67 TFLOP/s peak),
// not on the tensor cores (989 TFLOP/s bf16), so it runs an order of
// magnitude above the bf16 bound by construction; wgmma is a later
// change.
//
// What the design does about it:
// * One block of 256 threads per (head, batch, 64-query tile); it walks
//   only the 64-key tiles that the causal band needs (the TPU kernel's
//   block skip, flash_attn.py:37-42), on both sides of the band when
//   there is a window.  The blocks of the last (heaviest) query tiles
//   are scheduled first, so the causal imbalance leaves no long tail.
// * The Q tile and each K and V tile are staged in shared memory as f32
//   (dynamic shared memory: 212 KB at D = 256, past the 48 KB static
//   limit, after cudaFuncSetAttribute).  Rows are padded by 4 floats so
//   the 128-bit loads of 8 different rows fall in different banks.
// * Thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3 and, for
//   the scores, keys tx, tx+16, tx+32, tx+48 of the tile: a 4 x 4 register
//   tile fed by 128-bit shared loads along D.  The online-softmax state
//   (running max m, sum l) of its 4 rows lives in registers, reduced
//   across the 16 lanes of a row with shuffles; the output accumulator
//   (4 rows x D/16 columns) lives in registers too.
// * P goes through shared memory transposed ([key][row]) so that the PV
//   loop reads a thread's 4 probabilities of one key with one 128-bit
//   load.
// * A row whose keys in a tile are all masked (a window that starts
//   inside the tile, or rows past S) adds nothing: its max stays -inf and
//   its probabilities are 0, whatever order the tiles come in.  The
//   reference's -1e30 trick relies on a later real score to rescale such
//   garbage away; here there is none to rescale.
// * Ragged S: rows and keys past S are loaded as 0, keys past S are
//   masked, rows past S are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kRows = 4;           // query rows per thread
constexpr int kKeys = kBK / 16;    // keys per thread per tile
constexpr int kPStride = kBQ + 4;  // row stride of the transposed P tile
constexpr int kBadArgs = 1000;     // returned for arguments refused

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

template <int D>
struct Shape {
  static constexpr int kStride = D + 4;                // Q/K/V row, floats
  // output columns a load: 4 where D is a multiple of 64, so that a
  // thread's columns (ch * 16 + tx) * kVec .. + kVec - 1 of each chunk
  // tile D; one at D = 112 (seven chunks of 16 columns)
  static constexpr int kVec = D >= 64 ? (D % 64 == 0 ? 4 : 1) : D / 16;
  static constexpr int kChunks = D / (16 * kVec);       // loads a thread a row
  static constexpr int kCols = kChunks * kVec;          // = D / 16
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * kStride +
                       (size_t)kBK * kPStride);
};

// kVec consecutive floats of shared memory (aligned to kVec * 4 bytes)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

__device__ __forceinline__ float row_max(float x) {  // over the 16 lanes
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// a [rows, D] tile of a [B, S, H, D] tensor into shared memory as f32
// (rows past S as 0) in 16-byte loads: 4 f32 or 8 bf16 elements a
// thread, so a tile takes few round trips to device memory.  `base`
// points at (b, 0, h, 0) and is 16-byte aligned (the wrapper checks the
// tensors; D and H * D are multiples of 8); `row` is H * D.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          int64_t row, int start,
                                          int s_len) {
  constexpr int kStride = Shape<D>::kStride;
  constexpr int kN = 16 / sizeof(T);
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * D / kN; c += kThreads) {
    const int r = c * kN / D, d = c * kN % D;
    const int s = start + r;
    float f[kN];
    if (s < s_len) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + s * row + d);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kN; ++i) f[i] = to_f32(v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      *reinterpret_cast<float4*>(dst + r * kStride + d + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int s_len,
                      int hq, int hkv, int window, float scale) {
  using Sh = Shape<D>;
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kBQ * Sh::kStride;
  float* vs = ks + kBK * Sh::kStride;
  float* ps = vs + kBK * Sh::kStride;  // [kBK][kPStride], P transposed

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int hk = h / (hq / hkv);
  const int q_start = qi * kBQ;
  const int q_last = min(q_start + kBQ, s_len) - 1;

  const int64_t q_row = (int64_t)hq * D;  // stride of s in q and o
  const int64_t kv_row = (int64_t)hkv * D;
  const T* qb = q + ((int64_t)b * s_len * hq + h) * D;
  const T* kb = k + ((int64_t)b * s_len * hkv + hk) * D;
  const T* vb = v + ((int64_t)b * s_len * hkv + hk) * D;
  T* ob = o + ((int64_t)b * s_len * hq + h) * D;

  load_tile<T, D, kBQ>(qs, qb, q_row, q_start, s_len);

  // the key tiles the band needs: from the tile of the first row's first
  // key in the window to the tile of the last row's diagonal
  int kt_lo = 0;
  if (window > 0) {
    const int first = q_start - window + 1;
    kt_lo = first > 0 ? first / kBK : 0;
  }
  const int kt_hi = q_last / kBK;

  float m[kRows], l[kRows], acc[kRows][Sh::kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < Sh::kCols; ++c) acc[r][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();  // the last tile's K, V and P are no longer read
    load_tile<T, D, kBK>(ks, kb, kv_row, k_start, s_len);
    load_tile<T, D, kBK>(vs, vb, kv_row, k_start, s_len);
    __syncthreads();

    // scores of rows 4ty+r against keys tx+16c
    float sc[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) sc[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qv[r] = *reinterpret_cast<const float4*>(
            qs + (4 * ty + r) * Sh::kStride + d);
#pragma unroll
      for (int c = 0; c < kKeys; ++c)
        kv[c] = *reinterpret_cast<const float4*>(
            ks + (tx + 16 * c) * Sh::kStride + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) {
          float a = sc[r][c];
          a = fmaf(qv[r].x, kv[c].x, a);
          a = fmaf(qv[r].y, kv[c].y, a);
          a = fmaf(qv[r].z, kv[c].z, a);
          a = fmaf(qv[r].w, kv[c].w, a);
          sc[r][c] = a;
        }
    }

    // mask, then the online softmax of each row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q_start + 4 * ty + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int kpos = k_start + tx + 16 * c;
        const bool keep = kpos <= qpos && kpos < s_len &&
                          (window == 0 || kpos > qpos - window);
        sc[r][c] = keep ? sc[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      float alpha = 1.f, sum = 0.f;
      if (m_new == -INFINITY) {  // no key of this row kept so far
#pragma unroll
        for (int c = 0; c < kKeys; ++c) sc[r][c] = 0.f;
      } else {
        alpha = expf(m[r] - m_new);
#pragma unroll
        for (int c = 0; c < kKeys; ++c) {
          sc[r][c] = expf(sc[r][c] - m_new);
          sum += sc[r][c];
        }
      }
      l[r] = l[r] * alpha + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < Sh::kCols; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      *reinterpret_cast<float4*>(ps + (tx + 16 * c) * kPStride + 4 * ty) =
          make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
    }
    __syncthreads();

    // acc += P V over the keys that can be kept for this query tile
    const int j_end = min(kBK, q_last + 1 - k_start);
    for (int j = 0; j < j_end; ++j) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(ps + j * kPStride + 4 * ty);
      const float p[kRows] = {p4.x, p4.y, p4.z, p4.w};
      const float* vrow = vs + j * Sh::kStride;
#pragma unroll
      for (int ch = 0; ch < Sh::kChunks; ++ch) {
        float vv[Sh::kVec];
        load_vec<Sh::kVec>(vrow + (ch * 16 + tx) * Sh::kVec, vv);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int e = 0; e < Sh::kVec; ++e)
            acc[r][ch * Sh::kVec + e] =
                fmaf(p[r], vv[e], acc[r][ch * Sh::kVec + e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q_start + 4 * ty + r;
    if (s >= s_len) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + s * q_row;
#pragma unroll
    for (int ch = 0; ch < Sh::kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < Sh::kVec; ++e)
        orow[(ch * 16 + tx) * Sh::kVec + e] =
            from_f32<T>(acc[r][ch * Sh::kVec + e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int hq, int hkv, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = Shape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // z is scheduled last: every (head, batch) block of the last query
  // tile goes before any block of an earlier one
  const dim3 grid((unsigned)hq, (unsigned)b,
                  (unsigned)((s + kBQ - 1) / kBQ));
  flash_attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, hq, hkv, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int s, int hq, int hkv, int d, int window, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, s, hq, hkv, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, s, hq, hkv, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, s, hq, hkv, window, scale, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, b, s, hq, hkv, window, scale,
                            stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, s, hq, hkv, window, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, b, s, hq, hkv, window, scale,
                            stream);
    default:
      return kBadArgs;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns 0, a cudaError_t of the launch, or
// 1000 for arguments it refuses (the wrapper checks them first).
extern "C" int flash_attn_forward(int dtype, const void* q, const void* k,
                                  const void* v, void* o, int b, int s,
                                  int hq, int hkv, int d, int window,
                                  float scale, void* stream) {
  if (b <= 0 || s <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 ||
      window < 0 || b > 65535 || (s + kBQ - 1) / kBQ > 65535) {
    return kBadArgs;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_d<float>(q, k, v, o, b, s, hq, hkv, d, window, scale, st);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(q, k, v, o, b, s, hq, hkv, d, window,
                                   scale, st);
  }
  return kBadArgs;
}

// The dynamic shared memory a launch at head dim d asks for
// (Shape<d>::kSmem), or -1 for a head dim the library is not built for.
// The kernel audit holds its budget formula to it.
extern "C" long long flash_attn_smem_bytes(int d) {
  switch (d) {
    case 16:
      return (long long)Shape<16>::kSmem;
    case 32:
      return (long long)Shape<32>::kSmem;
    case 64:
      return (long long)Shape<64>::kSmem;
    case 112:
      return (long long)Shape<112>::kSmem;
    case 128:
      return (long long)Shape<128>::kSmem;
    case 256:
      return (long long)Shape<256>::kSmem;
    default:
      return -1;
  }
}
