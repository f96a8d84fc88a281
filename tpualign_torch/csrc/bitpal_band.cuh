// The pieces of a pipelined band fill that bitpal_gfill.cu (K1, K2 and
// K4's captures, a ring byte a column) and bitpal_rc.cu (K3a, K3b and K4's
// state, a ring byte a step) share word for word: the progress flags'
// release/acquire, a lane's match word, and the ticket by which a block
// takes its bands.  Each file keeps its own band body and states its own
// schedule.

#pragma once

#include "bitpal_step.cuh"

#include <cuda/atomic>

namespace {

__device__ __forceinline__ int load_acquire(int* flag) {
  return cuda::atomic_ref<int, cuda::thread_scope_device>(*flag).load(
      cuda::std::memory_order_acquire);
}

__device__ __forceinline__ void store_release(int* flag, int v) {
  cuda::atomic_ref<int, cuda::thread_scope_device>(*flag).store(
      v, cuda::std::memory_order_release);
}

// the match word of code c (kAlphabet and past: none)
__device__ __forceinline__ u64 match(const u64 (&e)[kAlphabet], unsigned c) {
  u64 E = 0;
#pragma unroll
  for (unsigned x = 0; x < kAlphabet; ++x) E = c == x ? e[x] : E;
  return E;
}

// The block's warp takes bands 0, 1, ... in order from the ticket
// (`ticket`, zeroed before the launch) and runs band(s) for each, until
// the ticket passes `bands`.  A band only ever waits on a lower band, which
// a running block holds, so no grid size deadlocks.
template <typename Band>
__device__ __forceinline__ void take_bands(int* ticket, int bands, Band&& band) {
  for (;;) {
    int x = 0;
    if (threadIdx.x == 0) x = atomicAdd(ticket, 1);
    const int s = __shfl_sync(0xffffffffu, x, 0);
    if (s >= bands) break;
    band(s);
  }
}

}  // namespace
