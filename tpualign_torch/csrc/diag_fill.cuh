// The flat anti-diagonal wavefront of diag_fill.cu (K8's port): the
// per-cell step and the diagonal loop.
//
// Recurrence (serial.cpp:23-31): H(i, j) = max(H(i-1, j-1) + s, H(i-1, j)
// + gap, H(i, j-1) + gap), boundaries H(0, j) = j*gap, H(i, 0) = i*gap (0
// under local, which also floors every cell at 0).
//
// Schedule: one thread block; element k of diagonal d is cell (i = k,
// j = d - k), and thread r computes the elements k = r, r + T, r + 2T, ...
// of each diagonal that lie in the table, so slot k always has the same
// owner, thread k mod T.  A cell reads diagonal d-1 at k-1 (up) and k
// (left) and diagonal d-2 at k-1 (diag), all in global memory, and
// s1[d-1-k] straight from global memory (the TPU kernel's rolled, staged
// window of s1 has no counterpart).  Three buffers rotate, one
// __syncthreads() per diagonal, no length cap.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace diagwave {

constexpr int kMaxThreads = 1024;

// Sweeps diagonals 1..n+m of the table of s1 (m columns) against s2 (n
// rows) through `diag`, (3, n+1) int32 whose row d mod 3 holds diagonal d.
// Slot k's owner calls cell(v) on each interior cell (i, j >= 1) under
// local scoring, v after the zero floor.
template <class Cell>
__device__ __forceinline__ void sweep(const int8_t* __restrict__ s1, int m,
                                      const int8_t* __restrict__ s2, int n,
                                      int match, int mismatch, int gap,
                                      bool local, int32_t* __restrict__ diag,
                                      Cell cell) {
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const int stride = n + 1;
  if (r == 0) diag[0] = 0;  // diagonal 0: H(0, 0)
  __syncthreads();
  for (int d = 1; d <= n + m; ++d) {
    int32_t* d0 = diag + (d % 3) * stride;
    const int32_t* d1 = diag + ((d + 2) % 3) * stride;
    const int32_t* d2 = diag + ((d + 1) % 3) * stride;
    const int klo = max(0, d - m);
    const int khi = min(d, n);
    for (int k = klo + ((r - klo % T) + T) % T; k <= khi; k += T) {
      int32_t v;
      if (k == 0 || k == d) {  // H(0, d) or H(d, 0)
        v = local ? 0 : d * gap;
      } else {
        const int32_t s = s1[d - 1 - k] == s2[k - 1] ? match : mismatch;
        v = __viaddmax_s32(max(d1[k - 1], d1[k]), gap, d2[k - 1] + s);
        if (local) {
          v = max(v, 0);
          cell(v);
        }
      }
      d0[k] = v;
    }
    __syncthreads();
  }
}

}  // namespace diagwave
