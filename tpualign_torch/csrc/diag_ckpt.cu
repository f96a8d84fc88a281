// Checkpointed flat anti-diagonal fill: pair scoring, linear gaps, global
// or local, for the diagonal-band traceback (ops/traceback_diag.py).
//
// Replaces the TPU kernel
// tpualign/ops/pallas_diag.py:_diag_ckpt_kernel_body (K9).  Contract, the
// same as ckpt_plain in tpualign_torch/ops/pallas_diag.py:
//
//   in:  s1    (m,)  int8 codes, across the columns
//        s2    (n,)  int8 codes, down the rows (the diagonal axis; either
//                    sequence may be the longer, nothing is swapped)
//        K     the checkpoint stride, groups = ceil((n+m)/K)
//   out: cka   (groups, n+1) int32: cka[c][k] = H(k, cK-k)
//        ckb   (groups, n+1) int32: ckb[c][k] = H(k, cK-1-k)
//              on the slots that lie in the table, NEG = -2^30 on every
//              other slot (row 0: diagonal 0, only H(0, 0) = 0, and
//              diagonal -1, all NEG)
//        v     (n+1,) int32, local only: the max over row k's cells with
//              j >= 1, floored at 0
//        dbest (n+1,) int32, local only: the first diagonal at which that
//              max was strictly reached, or 0
//   scratch: diag (3, n+1) int32, three rotating diagonals
//
// The recurrence and the schedule are diag_fill.cuh's wavefront, K8's.
// Where the TPU kernel DMAs its (diag cK, diag cK-1) VMEM buffers to HBM
// before each group of K steps, here each slot's owner writes its own
// slots of diagonals cK-1 and cK to the checkpoint rows as soon as it has
// computed them (no barrier: the owner of slot k wrote d0[k] itself), and
// writes NEG to the dead ones, which the rotating buffers leave stale.
// v and dbest live in global memory, each slot read and written only by
// its owner, so they need no atomics; `improved = v > v[k]` keeps the TPU
// kernel's strict rule (pallas_diag.py:168-180).
//
// What bounds it: K8's wavefront, one SM walking n + m diagonals of up to
// n cells behind a barrier each; the checkpoints add 2(n+1) stores every
// K diagonals, and local scoring a load and a compare a cell.  Later work:
// shared-memory diagonals and a tiled wavefront, as for K8.

#include "diag_fill.cuh"

namespace {

using diagwave::kMaxThreads;

constexpr int32_t kNeg = -(1 << 30);

__global__ void __launch_bounds__(kMaxThreads)
    diag_ckpt_kernel(const int8_t* __restrict__ s1, int m,
                     const int8_t* __restrict__ s2, int n, int match,
                     int mismatch, int gap, bool local, int K,
                     int32_t* __restrict__ diag, int32_t* __restrict__ cka,
                     int32_t* __restrict__ ckb, int32_t* __restrict__ vbest,
                     int32_t* __restrict__ dbest) {
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const size_t stride = static_cast<size_t>(n) + 1;
  const int groups = (n + m + K - 1) / K;
  for (int k = r; k <= n; k += T) {  // group 0: diagonals 0 and -1
    cka[k] = k == 0 ? 0 : kNeg;
    ckb[k] = kNeg;
    if (local) {
      vbest[k] = 0;
      dbest[k] = 0;
    }
  }
  diagwave::sweep(
      s1, m, s2, n, match, mismatch, gap, local, diag,
      [&](int d, int k, int32_t v) {
        if (v > vbest[k]) {
          vbest[k] = v;
          dbest[k] = d;
        }
      },
      [&](int d, const int32_t* d0, int klo, int khi) {
        const int t = d % K;
        const int c = (d + 1) / K;  // d = cK or d = cK - 1
        if ((t != 0 && t != K - 1) || c >= groups) return;
        int32_t* ck = (t == 0 ? cka : ckb) + c * stride;
        for (int k = r; k <= n; k += T) {
          ck[k] = (k >= klo && k <= khi) ? d0[k] : kNeg;
        }
      });
}

}  // namespace

// Launches the checkpointed fill on `stream` with `threads` threads (a
// multiple of 32, at most 1024) and stride K (a multiple of 8).  `diag` is
// (3, n+1) int32 scratch; cka and ckb are (ceil((n+m)/K), n+1) int32, v and
// dbest (n+1,) int32, written under local scoring only.  Returns the
// cudaError_t of the launch; the fill itself runs asynchronously.
extern "C" int diag_ckpt_fill(const void* s1, int m, const void* s2, int n,
                              int match, int mismatch, int gap, int local,
                              int K, int threads, void* diag, void* cka,
                              void* ckb, void* v, void* dbest, void* stream) {
  if (n < 1 || m < 1 || K < 8 || K % 8 != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  diag_ckpt_kernel<<<1, threads, 0, s>>>(
      static_cast<const int8_t*>(s1), m, static_cast<const int8_t*>(s2), n,
      match, mismatch, gap, local != 0, K, static_cast<int32_t*>(diag),
      static_cast<int32_t*>(cka), static_cast<int32_t*>(ckb),
      static_cast<int32_t*>(v), static_cast<int32_t*>(dbest));
  return static_cast<int>(cudaGetLastError());
}
