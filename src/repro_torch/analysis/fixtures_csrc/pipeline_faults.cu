// Planted pipeline faults: the card half of the `pipeline` fixture of
// repro_torch.analysis (the port's counterpart of the reference's `dma`
// fixture, src/repro/analysis/fixtures.py:24-32, a K-slab rotation whose
// last copies are never waited).  Three small kernels, each with one
// fault, built with the checked build's log (pipeline_check.cuh, always
// on here) so that kernel_audit.check_pipeline_log must flag each:
//
// * ring_kernel, mode 0: a two-stage mbarrier ring fed by bulk copies
//   (cp.async.bulk, the TMA's one-dimensional form) whose producer never
//   waits on `empty`: it re-arms a stage once its own copy has landed,
//   while the consumer warps may still be reading it;
// * ring_kernel, mode 1: the same ring, correct but for its last fill,
//   whose copies are one box short of the bytes its expect_tx armed: the
//   consumers' wait on that fill never completes and the bounded wait of
//   the checked build times out instead of hanging the card;
// * cp_async_kernel: a cp.async double buffer that refills a buffer with
//   no __syncthreads after the last read of its old tile (a
//   write-after-read race).
//
// Not a port of a TPU kernel and on no path of the port: it exists to be
// flagged.  Each runs one block on a few kilobytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline_check.cuh"
#include "wgmma.cuh"

namespace {

using namespace fa_sm90;

constexpr int kStages = 2;
constexpr int kConsumerWarps = 2;
constexpr int kRingThreads = 32 * (kConsumerWarps + 1);
constexpr int kBoxFloats = 512;                 // one bulk copy: 2 KB
constexpr int kBoxes = 2;                       // a ring stage: 4 KB
constexpr uint32_t kBox = kBoxFloats * 4;
constexpr uint32_t kStageBytes = kBoxes * kBox;
constexpr int kStageFloats = kBoxes * kBoxFloats;
constexpr int kCpThreads = 128;
constexpr int kCpFloats = 1024;                 // a double-buffer tile: 4 KB

__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  PC_LOG(kTma, bar, dst, -1, bytes, -1);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// barriers in flash_attn_wgmma.cu's layout: full (its full_k) at slot st,
// empty at slot 2 * kStages + st (the full_v and q_full slots unused)
__global__ void __launch_bounds__(kRingThreads)
    ring_kernel(const float* __restrict__ src, float* __restrict__ out,
                int n_tiles, int mode) {
  __shared__ __align__(128) float ring[kStages][kStageFloats];
  __shared__ __align__(8) uint64_t bars[3 * kStages + 1];
  const uint32_t sk = smem_addr(ring), bar = smem_addr(bars);
  auto full = [&](int st) { return bar + 8 * st; };
  auto empty = [&](int st) { return bar + 8 * (2 * kStages + st); };
  if (threadIdx.x == 0) {
    PC_LOG(kLayout, -1, sk, -1, bar, kStageBytes);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    if (lane == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        if (mode != 0) {
          mbar_wait(empty(st), ph ^ 1);
        } else if (it >= kStages) {
          mbar_wait(full(st), ph ^ 1);  // fault: its own copy, not the release
        }
        mbar_expect_tx(full(st), kStageBytes);
        // fault (mode 1): the last fill's copies one box short
        const int boxes = mode == 1 && it == n_tiles - 1 ? kBoxes - 1 : kBoxes;
        for (int p = 0; p < boxes; ++p)
          bulk_load(sk + st * kStageBytes + p * kBox,
                    src + (int64_t)it * kStageFloats + p * kBoxFloats, kBox,
                    full(st));
      }
    }
    return;
  }
  float acc = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(full(st), (it / kStages) & 1);
    PC_LANE0_LOG(kRead, sk + st * kStageBytes, -1, -1, 0, it);
    for (int i = threadIdx.x; i < kStageFloats; i += 32 * kConsumerWarps)
      acc += ring[st][i];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
  out[threadIdx.x] = acc;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void load(float* dst, const float* src, int tile) {
  PC_LANE0_LOG(kLoad, smem_addr(dst), -1, -1, 0, tile);
  for (int c = threadIdx.x; c < kCpFloats / 4; c += kCpThreads)
    cp_async16(smem_addr(dst + 4 * c), src + (int64_t)tile * kCpFloats + 4 * c);
  asm volatile("cp.async.commit_group;\n" ::);
  PC_LANE0_LOG(kCommit, -1, -1, -1, 0, tile);
}

__global__ void __launch_bounds__(kCpThreads)
    cp_async_kernel(const float* __restrict__ src, float* __restrict__ out,
                    int n_tiles) {
  __shared__ __align__(16) float buf[2][kCpFloats];
  if (threadIdx.x == 0)
    PC_LOG(kLayout, smem_addr(buf[0]), smem_addr(buf[1]), -1, -1, 0);
  float acc = 0.f;
  load(buf[0], src, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load(buf[(t + 1) % 2], src, t + 1);
      cp_async_wait<1>();
      PC_LANE0_LOG(kWaitGroup, -1, -1, 1, 0, t);
    } else {
      cp_async_wait<0>();
      PC_LANE0_LOG(kWaitGroup, -1, -1, 0, 0, t);
    }
    __syncthreads();
    PC_LANE0_LOG(kSync, -1, -1, 1, 0, t);
    PC_LANE0_LOG(kRead, smem_addr(buf[t % 2]), -1, -1, 0, t);
    for (int i = threadIdx.x; i < kCpFloats; i += kCpThreads)
      acc += buf[t % 2][(i * 7 + 32 * (threadIdx.x / 32)) % kCpFloats];
    // fault: no __syncthreads() here, so the next iteration refills
    // buf[t % 2] while slower warps may still be reading tile t
  }
  out[threadIdx.x] = acc;
}

}  // namespace

// mode 0: the producer skips its wait on `empty`; mode 1: the last fill
// is one box short.  Returns 0 or a cudaError_t.
extern "C" int pipeline_fault_ring(int mode, const float* src, float* out,
                                   int n_tiles, int* log, int cap,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int err = pc::set_log(log, cap, st)) return err;
  ring_kernel<<<1, kRingThreads, 0, st>>>(src, out, n_tiles, mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pipeline_fault_cp_async(const float* src, float* out,
                                       int n_tiles, int* log, int cap,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int err = pc::set_log(log, cap, st)) return err;
  cp_async_kernel<<<1, kCpThreads, 0, st>>>(src, out, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pipeline_check_record_bytes() {
  return (int)(pc::kFields * sizeof(int));
}
