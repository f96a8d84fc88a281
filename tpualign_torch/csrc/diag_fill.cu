// Flat anti-diagonal score: pair scoring, linear gaps, global or local.
//
// Replaces the TPU kernel tpualign/ops/pallas_diag.py:_diag_kernel_body
// (K8).  Contract, the same as score_plain in
// tpualign_torch/ops/pallas_diag.py:
//
//   in:  s1   (m,)  int8 codes, across the columns (the longer sequence)
//        s2   (n,)  int8 codes, down the rows (the diagonal axis, n <= m)
//   out: out  (1,)  int32: H(n, m) (global), or the max over every cell
//                   and 0 (local)
//   scratch: diag (3, n+1) int32, three rotating diagonals
//
// The recurrence and the schedule are diag_fill.cuh's wavefront.
//
// What bounds it: one SM walks n + m diagonals, each a barrier plus up to
// n cells of three dependent loads from L1/L2; the other SMs idle.  Later
// work: keep the diagonals in shared memory for n up to ~18k, and a tiled
// wavefront over many blocks.

#include "diag_fill.cuh"

namespace {

using diagwave::kMaxThreads;

__global__ void __launch_bounds__(kMaxThreads)
    diag_fill_kernel(const int8_t* __restrict__ s1, int m,
                     const int8_t* __restrict__ s2, int n, int match,
                     int mismatch, int gap, bool local,
                     int32_t* __restrict__ diag, int32_t* __restrict__ out) {
  __shared__ int32_t red[kMaxThreads / 32];
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const int stride = n + 1;
  int32_t best = 0;
  diagwave::sweep(
      s1, m, s2, n, match, mismatch, gap, local, diag,
      [&](int32_t v) { best = max(best, v); });
  if (local) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      best = max(best, __shfl_down_sync(0xffffffffu, best, off));
    }
    if ((r & 31) == 0) red[r >> 5] = best;
    __syncthreads();
    if (r == 0) {
      for (int w = 1; w < T / 32; ++w) best = max(best, red[w]);
      *out = best;
    }
  } else if (r == 0) {
    *out = diag[((n + m) % 3) * stride + n];
  }
}

}  // namespace

// Launches the diagonal fill on `stream` with `threads` threads (a multiple
// of 32, at most 1024); n <= m.  `diag` is (3, n+1) int32 scratch; the
// score lands in out[0].  Returns the cudaError_t of the launch; the fill
// itself runs asynchronously.
extern "C" int diag_fill(const void* s1, int m, const void* s2, int n,
                         int match, int mismatch, int gap, int local,
                         int threads, void* diag, void* out, void* stream) {
  if (n < 1 || m < n || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  diag_fill_kernel<<<1, threads, 0, s>>>(
      static_cast<const int8_t*>(s1), m, static_cast<const int8_t*>(s2), n,
      match, mismatch, gap, local != 0, static_cast<int32_t*>(diag),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
