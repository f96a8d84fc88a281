// Bit-parallel Needleman-Wunsch fill for the scoring family (1, 0, -1).
//
// Replaces the TPU kernel tpualign/ops/bitpal.py:_bitpal_kernel_body_lean
// (and its A/B twin _bitpal_kernel_body).  Contract, word for word the same
// as fill_plain in tpualign_torch/ops/bitpal.py:
//
//   in:  text  (mt,)     int8, codes 0..4 (other codes match nothing)
//        eq    (5, nw)   uint64, bit b of eq[c][w] set iff query[64w+b] == c
//   out: b0, b1 (nw,)    uint64, the final column's vertical deltas
//                        v(i, mt) as two planes of enc = v + 1
//
// Query rows are packed 64 to a word (row 64w+b is bit b of word w).  One
// column step of a word is the plane algebra of plane_step in
// bitpal_step.cuh; see the derivation in the module docstring of
// tpualign/ops/bitpal.py.
//
// Schedule: one thread block.  Thread t owns words [t*K, t*K+K) and keeps
// their two delta planes in registers.  At step d thread t computes column
// j = d - t for all of its words, top to bottom, handing the 2-bit h_out of
// one word to the next in registers.  The h_out of its last word goes to
// thread t+1 through a parity double buffer in shared memory, read one step
// later; one __syncthreads() per step orders the two.  Column 0 (v = gap,
// enc 0) is the all-zero initial state; word 0's h_top is the top boundary
// (h = gap, enc 0).
//
// What bounds it: everything runs on one SM, so each of the mt + T - 1 steps
// pays a block-wide barrier plus T*K word steps of ~25 64-bit integer ops
// (each two 32-bit ops) issued by that SM alone; the other SMs idle.  Later
// work: a multi-block wavefront (blocks own word bands and hand the band's
// bottom h_out stream to the next block through global memory with flags),
// warp-shuffle hand-offs inside a warp in place of the shared-memory buffer,
// and prefetching text chars ahead of the step that uses them.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitpal_step.cuh"

namespace {

using bitpal::kAlphabet;
using bitpal::kMaxThreads;
using bitpal::plane_step;
using bitpal::u64;

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
    bitpal_fill_kernel(const int8_t* __restrict__ text,
                       const u64* __restrict__ eq, int64_t mt, int nw,
                       u64* __restrict__ b0_out, u64* __restrict__ b1_out) {
  __shared__ uint8_t hand[2][kMaxThreads];
  const int t = threadIdx.x;
  const int w0 = t * K;
  u64 b0[K], b1[K];
#pragma unroll
  for (int i = 0; i < K; ++i) b0[i] = b1[i] = 0;

  const int64_t steps = mt + blockDim.x - 1;
  for (int64_t d = 1; d <= steps; ++d) {
    const int64_t j = d - t;
    if (j >= 1 && j <= mt) {
      const int c = text[j - 1];
      u64 u0 = 0, u1 = 0;
      if (t > 0) {
        const unsigned h = hand[(d - 1) & 1][t - 1];
        u0 = h & 1;
        u1 = h >> 1;
      }
      const bool known = c >= 0 && c < kAlphabet;
      const u64* e = eq + (known ? c : 0) * static_cast<int64_t>(nw) + w0;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const u64 E = (known && w0 + i < nw) ? e[i] : 0;
        u64 U0, U1;  // every row's h_out, unused without captures
        plane_step(E, b0[i], b1[i], u0, u1, U0, U1);
      }
      hand[d & 1][t] = static_cast<uint8_t>(u0 | (u1 << 1));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (w0 + i < nw) {
      b0_out[w0 + i] = b0[i];
      b1_out[w0 + i] = b1[i];
    }
  }
}

}  // namespace

// Launches the fill on `stream` with `threads` threads of k words each
// (threads * k >= nw, threads <= 1024, k in {1, 2, 4, 8, 16}).  Returns the
// cudaError_t of the launch; the fill itself runs asynchronously.
extern "C" int bitpal_fill(const void* text, const void* eq, int64_t mt,
                           int nw, int k, int threads, void* b0, void* b1,
                           void* stream) {
  const auto* tx = static_cast<const int8_t*>(text);
  const auto* q = static_cast<const u64*>(eq);
  auto* o0 = static_cast<u64*>(b0);
  auto* o1 = static_cast<u64*>(b1);
  auto s = static_cast<cudaStream_t>(stream);
  if (threads < 1 || threads > kMaxThreads ||
      static_cast<int64_t>(threads) * k < nw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (k) {
    case 1: bitpal_fill_kernel<1><<<1, threads, 0, s>>>(tx, q, mt, nw, o0, o1); break;
    case 2: bitpal_fill_kernel<2><<<1, threads, 0, s>>>(tx, q, mt, nw, o0, o1); break;
    case 4: bitpal_fill_kernel<4><<<1, threads, 0, s>>>(tx, q, mt, nw, o0, o1); break;
    case 8: bitpal_fill_kernel<8><<<1, threads, 0, s>>>(tx, q, mt, nw, o0, o1); break;
    case 16: bitpal_fill_kernel<16><<<1, threads, 0, s>>>(tx, q, mt, nw, o0, o1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
