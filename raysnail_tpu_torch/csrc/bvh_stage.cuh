// Staging a leaf block's sweep rows in shared memory with the bulk copy
// engine (TMA, 1-D cp.async.bulk), shared by the packet kernel's `stream`
// mode (bvh_packet.cu: a ring of slots per warp) and the probes that sweep
// a packet's leaves (bvh_probes.cu: a ring of slots per block). One thread
// asks for a copy and no thread spends an instruction on it; an mbarrier a
// slot completes its phase when all the bytes have landed, and a sweep
// waits only for its own slot's.

#pragma once

#include "bvh_sweep.cuh"

namespace bvh {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// one thread: set up the mbarrier at `bar_ptr` for one arrival, the one of
// `stage`
__device__ __forceinline__ void mbar_init(unsigned long long* bar_ptr) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar_ptr))
               : "memory");
}

// every thread that set up an mbarrier, before the barrier that publishes
// it: makes the set-up visible to the bulk copy engine
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: start the copy of one leaf's sweep rows into a ring slot with
// the bulk copy engine (TMA, 1-D); the mbarrier at `bar_ptr` completes its
// phase when all the bytes have landed. tri_mxu: rows 0-9 of the solve
// table (640-lane rows in global memory, 512-lane rows in the slot), then
// the valid row (row 0 of the attribute table)
template <int KIND>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      unsigned long long* bar_ptr) {
  const unsigned bar = smem_addr(bar_ptr);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"((unsigned)(Shape<KIND>::staged * sizeof(float))) : "memory");
  if (KIND == kTriMxu) {
    for (int row = 0; row < 10; ++row)
      bulk_copy(dst + row * kSolveLanes, src + row * kMxuLanes, kSolveLanes * 4, bar);
    bulk_copy(dst + 10 * kSolveLanes, src + kSolveLanes, kLanes * 4, bar);
  } else {
    bulk_copy(dst, src, Shape<KIND>::staged * 4, bar);
  }
}

// every lane: wait for the phase of `bar_ptr` with the given parity to end
__device__ __forceinline__ void mbar_wait(unsigned long long* bar_ptr, unsigned parity) {
  const unsigned bar = smem_addr(bar_ptr);
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

}  // namespace bvh
