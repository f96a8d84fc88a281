// Flat anti-diagonal score: pair scoring, linear gaps, global or local.
//
// Replaces the TPU kernel tpualign/ops/pallas_diag.py:_diag_kernel_body
// (K8).  Contract, the same as score_plain in
// tpualign_torch/ops/pallas_diag.py:
//
//   in:  s1   (m,)  int8 codes, across the columns (the longer sequence)
//        s2   (n,)  int8 codes, down the rows (the diagonal axis, n <= m)
//   out: out  (1,)  int32: H(n, m) (global), or the max over every cell
//                   and 0 (local).  The caller fills it with the max's
//                   identity (0 local, -2^30 global): each block maxes
//                   into it
//   scratch: the strip pipeline's ring and flags (band_fill.cuh)
//
// The TPU kernel walks the anti-diagonals of the table in VMEM, one
// diagonal a step.  Its result is one exact cell value, H(n, m), or under
// local scoring the max over every cell and 0; neither depends on the
// order in which the cells are filled, so here it comes from band_fill.cuh's
// row strips (fill_pipe, as diag_ckpt.cu's K9): s1 is the strips' text and
// s2 their query, pair scoring, linear gaps, local as kLocal | kZeroRow |
// kZeroCol.  The strips run side by side over many thread blocks, each
// strip's bottom row handed down through the ring; the thread that owns
// row n maxes H(n, m) into out (global), every thread its cells' max
// (local).  n <= m puts the shorter sequence across the strips' rows, the
// orientation band.plan gives K6, so the strips are as few as they can be.
//
// What bounds it: the pipeline's step, as in K6 (band_fill.cuh's note):
// about m + T + (S-1)(T + 2 kChunk) steps of k rows a thread and a block
// barrier each.

#include "band_fill.cuh"

namespace {

// K8's port: the pipelined strips under pair scoring and linear gaps
template <int K, bool LOCAL>
__global__ void __launch_bounds__(kPipeThreads) diag_fill_kernel(Params p, Pipe q) {
  fill_pipe<K, false, false, LOCAL, false, false, false>(p, CaptureArgs{}, q, CkptArgs{});
}

template <bool LOCAL>
int launch_diag(int k, int threads, int blocks, cudaStream_t s, const Params& p,
                const Pipe& q) {
  switch (k) {
#define DIAG_CASE(K)                                                          \
  case K:                                                                     \
    diag_fill_kernel<K, LOCAL><<<blocks, threads, 0, s>>>(p, q);              \
    break;
    DIAG_CASE(1)
    DIAG_CASE(2)
    DIAG_CASE(4)
    DIAG_CASE(8)
    DIAG_CASE(16)
#undef DIAG_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the diagonal score on `stream`, n <= m: `blocks` blocks of
// `threads` threads (a multiple of 32, at most 256) of k rows each (k in
// {1, 2, 4, 8, 16}), S = ceil(n / (k*threads)) strips over the rows (s2).
// `ring` is (depth, 1, m+1) int32 scratch, depth >= 2, when S >= 2 (else
// unused); `sync` is (S + 2,) int32, zeroed.  The score maxes into out[0],
// which the caller fills with 0 (local) or -2^30.  Returns the cudaError_t
// of the launch; the fill itself runs asynchronously.
extern "C" int diag_fill(const void* s1, int m, const void* s2, int n, int match,
                         int mismatch, int gap, int local, int k, int threads, int blocks,
                         void* ring, int depth, void* sync, void* out, void* stream) {
  Pipe q;
  if (m < n || out == nullptr ||
      !pipe_args(m, n, 0, k, threads, blocks, ring, depth, sync, nullptr, false, q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const int8_t*>(s1),
                 m,
                 static_cast<const int8_t*>(s2),
                 n,
                 nullptr,
                 0,
                 match,
                 mismatch,
                 gap,
                 0,
                 0,
                 local ? (kLocal | kZeroRow | kZeroCol) : 0,
                 nullptr,
                 nullptr,
                 static_cast<int32_t*>(out)};
  auto s = static_cast<cudaStream_t>(stream);
  return local ? launch_diag<true>(k, threads, blocks, s, p, q)
               : launch_diag<false>(k, threads, blocks, s, p, q);
}
