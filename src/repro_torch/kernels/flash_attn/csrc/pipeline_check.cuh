// The pipeline-event log of the checked build (REPRO_PIPELINE_CHECK), the
// port's counterpart of the reference's DMA/semaphore pairing check
// (src/repro/analysis/pallas_audit.py:150-410, which ran the Pallas kernel
// body on stubs and logged every make_async_copy start and wait).  Here
// the real kernels run on the card, compiled from the same sources with
// -DREPRO_PIPELINE_CHECK, and every pipeline event is written to a log
// that repro_torch.analysis.kernel_audit.check_pipeline_log holds to the
// pipeline's rules on the host.
//
// Without the define every macro below expands to nothing: the normal
// build's code and resources are unchanged.
//
// Log layout: a block owns (cap + 1) records of kFields int32, cap being
// the capacity the entry point is given; the block's linear index is
// blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z).  Its
// first record is a header: [0] the records taken (a counter that every
// logging thread of the block takes its seq from by atomicAdd), [1] 1 if
// a record did not fit.  Records follow at index 1 + seq:
//
//   seq, actor (threadIdx.x / 32), kind, obj, stage, parity, bytes, tile
//
// What obj .. tile hold depends on the kind (kernel_audit.PC_KINDS):
// shared-memory addresses of the barrier or buffer an event touches (the
// host maps them to names with the block's kLayout record), a wait's
// parity, byte counts, and the tile the kernel means.  A full region
// raises the flag and drops the record: it never wraps.
#pragma once

#ifdef REPRO_PIPELINE_CHECK

#include <cuda_runtime.h>
#include <stdint.h>

namespace pc {

enum Kind : int {
  kLayout = 1,  // obj, stage, parity: three buffer bases; bytes: barrier
                // base (-1: none); tile: bytes of one ring stage
  kInit,        // obj: barrier; bytes: arrival count
  kExpectTx,    // obj: barrier; bytes: transaction bytes armed
  kTma,         // obj: barrier; stage: destination; bytes; tile: row
  kWait,        // obj: barrier; parity (after the phase completed)
  kTimeout,     // obj: barrier; parity (the bounded wait gave up)
  kArrive,      // obj: barrier
  kMmaCommit,   // obj: B operand's stage; stage: A operand (-1: registers)
  kMmaRetire,   //   the same; tile: the key tile
  kLoad,        // cp.async: obj: destination buffer; tile
  kCommit,      // cp.async.commit_group
  kWaitGroup,   // cp.async.wait_group; parity: N
  kSync,        // __syncthreads; parity: its site in the source; tile
  kRead,        // obj: buffer read; tile: the tile the reader expects
};

constexpr int kFields = 8;
// a wait that has not completed after this many cycles (~0.1 s at the
// H100's 1.98 GHz) logs kTimeout and returns: a pairing fault shows as a
// finding, not as a hung card
constexpr long long kTimeoutCycles = 200000000LL;

struct Log {
  int* buf;
  int cap;  // records a block
};

// one per translation unit; set by the entry point before its launch
static __device__ Log g_log;

__device__ __forceinline__ void log(int kind, int obj, int stage, int parity,
                                    int bytes, int tile) {
  const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  int* region = g_log.buf + (int64_t)blk * (g_log.cap + 1) * kFields;
  const int seq = atomicAdd(region, 1);
  if (seq >= g_log.cap) {
    region[1] = 1;
    return;
  }
  int* rec = region + kFields * (1 + seq);
  rec[0] = seq;
  rec[1] = threadIdx.x / 32;
  rec[2] = kind;
  rec[3] = obj;
  rec[4] = stage;
  rec[5] = parity;
  rec[6] = bytes;
  rec[7] = tile;
  // the record and its seq are taken before the operation it stands for
  __threadfence_block();
}

__device__ __forceinline__ bool lane0() { return (threadIdx.x & 31) == 0; }

static inline int set_log(int* buf, int cap, cudaStream_t stream) {
  const Log l{buf, cap};
  return static_cast<int>(cudaMemcpyToSymbolAsync(
      g_log, &l, sizeof(l), 0, cudaMemcpyHostToDevice, stream));
}

}  // namespace pc

#define PC_LOG(kind, ...) ::pc::log(::pc::kind, __VA_ARGS__)
// warp-uniform events, logged once a warp
#define PC_LANE0_LOG(kind, ...)                              \
  do {                                                       \
    if (::pc::lane0()) ::pc::log(::pc::kind, __VA_ARGS__);   \
  } while (0)
// the checked entry points take the log and its capacity (records a block)
#define PC_ENTRY_PARAMS , int *pc_log, int pc_cap
#define PC_SET_LOG(stream)                                            \
  do {                                                                \
    if (const int pc_err = ::pc::set_log(pc_log, pc_cap, (stream)))   \
      return pc_err;                                                  \
  } while (0)
// a checked build compiles only the head dims its cases need: `mask`
// holds a bit per d / 16 (kernels/flash_attn/build.py CHECKED_DIMS)
#define PC_BUILT(mask, d) ((((mask) >> ((d) / 16)) & 1) != 0)

#else

#define PC_LOG(kind, ...) ((void)0)
#define PC_LANE0_LOG(kind, ...) ((void)0)
#define PC_ENTRY_PARAMS
#define PC_SET_LOG(stream) ((void)0)
#define PC_BUILT(mask, d) true

#endif
