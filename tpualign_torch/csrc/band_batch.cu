// Entry point band_batch_fill: the strip score of band_fill.cuh (K6's
// contract) over a batch of pairs, one thread block per pair, the whole
// batch in one launch.
//
// Replaces the batch contract of the TPU kernel
// tpualign/ops/band_align.py:_strip_kernel_body (K7) as
// tpualign/ops/band_batch.py:score_batch runs it: one bottom-aligned strip
// per pair, the pairs strung through a lax.scan.  Contract, pair for pair
// the same as score_batch in tpualign_torch/ops/xla.py:
//
//   in:  texts, queries   int8 codes, packed: pair p's text (columns) is
//                         texts[toff[p] .. toff[p] + m[p]), its query
//                         (rows) queries[qoff[p] .. qoff[p] + n[p])
//        toff, qoff (P,)  int64; m, n (P,) int32, each at least 1
//        matrix, flags    as band_fill (every pair in one orientation, so
//                         no pair transposes the matrix or the flags)
//   out: out      (P,)    int32, pair p's result under band_fill's
//                         contract: local, the max over its cells
//                         1 <= j <= m[p] and 0; with er / ec, the max over
//                         its row n[p] / column m[p]; otherwise
//                         H(n[p], m[p])
//   scratch: boundary (P, 2, m_cap+1) int32, each pair's boundary rows
//
// Block p builds its Params from the per-pair arrays and runs the strip
// body of band_fill.cuh in its in-place schedule (fill_inplace), strip by
// strip through the pair's boundary rows, so a pair longer than one strip
// is served.  The per-pair arrays ride in an argument of this kernel alone
// (BatchArgs), and the pipeline's scratch stays out of it.  One geometry
// serves the launch; threads past a pair's last row idle through its
// steps.  Local affine stops at 8 rows a thread, as in
// band.max_k.
//
// What the TPU layout does and this one does not: its pairs run one after
// another through one strip kernel in a scan, bottom-aligned in the strip
// with a first live slot, the text packed 8 codes a word and the boundary
// row in SMEM under a length cap; it refuses affine gaps, masked local
// scoring and pairs past one strip.  Here the pairs are independent
// blocks over the card's 132 SMs, and each block runs the fill that
// band_fill runs, so it takes all of them.
//
// What bounds it: each block issues every cell of its pair (about 8
// integer instructions a cell) plus a block barrier per step; a batch uses
// min(P, 132 x resident blocks) SMs, and the longest pair sets the time
// of a small batch.

#include "band_fill.cuh"

namespace {

struct BatchArgs {
  const int64_t* toff;
  const int64_t* qoff;
  const int32_t* m;
  const int32_t* n;
  int32_t* boundary;  // (P, 2, m_cap+1)
  int64_t m_cap;
};

template <int K, bool AFFINE, bool MATRIX, bool LOCAL>
__global__ void __launch_bounds__(kMaxThreads)
    band_batch_kernel(Params p, BatchArgs a) {
  const int64_t b = blockIdx.x;
  p.text += a.toff[b];
  p.m = a.m[b];
  p.query += a.qoff[b];
  p.n = a.n[b];
  p.bh = a.boundary + b * 2 * (a.m_cap + 1);
  p.bf = p.bh + a.m_cap + 1;
  p.out += b;
  fill_inplace<K, AFFINE, MATRIX, LOCAL>(p);
}

template <bool AFFINE, bool MATRIX, bool LOCAL>
int launch_batch(int k, int pairs, int threads, cudaStream_t s,
                 const Params& p, const BatchArgs& a) {
  switch (k) {
#define BATCH_CASE(K)                                                        \
  case K:                                                                    \
    if constexpr (AFFINE && LOCAL && K > 8) {                                \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    } else {                                                                 \
      band_batch_kernel<K, AFFINE, MATRIX, LOCAL><<<pairs, threads, 0, s>>>(p, a); \
    }                                                                        \
    break;
    BATCH_CASE(1)
    BATCH_CASE(2)
    BATCH_CASE(4)
    BATCH_CASE(8)
    BATCH_CASE(16)
#undef BATCH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool AFFINE>
int launch_batch_mode(int k, int pairs, int threads, cudaStream_t s,
                      const Params& p, const BatchArgs& a) {
  const bool local = p.flags & kLocal;
  if (p.K > 0) {
    return local ? launch_batch<AFFINE, true, true>(k, pairs, threads, s, p, a)
                 : launch_batch<AFFINE, true, false>(k, pairs, threads, s, p, a);
  }
  return local ? launch_batch<AFFINE, false, true>(k, pairs, threads, s, p, a)
               : launch_batch<AFFINE, false, false>(k, pairs, threads, s, p, a);
}

}  // namespace

// Launches the batch fill on `stream`: `pairs` blocks of `threads` threads
// (a multiple of 32, at most 1024) of k rows each (k in {1, 2, 4, 8, 16};
// at most 8 under local affine scoring); scoring and flags as band_fill.
// Pair p's result lands in out[p].  `boundary` is (pairs, 2, m_cap+1)
// int32 scratch, m_cap at least every m[p].  Returns the cudaError_t of the
// launch; the fill itself runs asynchronously.
extern "C" int band_batch_fill(const void* texts, const void* queries,
                               const void* toff, const void* qoff,
                               const void* m, const void* n, int pairs,
                               int64_t m_cap, const void* matrix, int K,
                               int match, int mismatch, int gap, int gap_open,
                               int gap_extend, int flags, int k, int threads,
                               void* boundary, void* out, void* stream) {
  if (bad_geometry(1, 1, K, threads) || pairs < 1 || m_cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const int8_t*>(texts),
                 0,
                 static_cast<const int8_t*>(queries),
                 0,
                 static_cast<const int32_t*>(matrix),
                 K,
                 match,
                 mismatch,
                 gap,
                 gap_open,
                 gap_extend,
                 flags,
                 nullptr,
                 nullptr,
                 static_cast<int32_t*>(out)};
  const BatchArgs a{static_cast<const int64_t*>(toff),
                    static_cast<const int64_t*>(qoff),
                    static_cast<const int32_t*>(m),
                    static_cast<const int32_t*>(n),
                    static_cast<int32_t*>(boundary), m_cap};
  auto s = static_cast<cudaStream_t>(stream);
  return (flags & kAffine)
             ? launch_batch_mode<true>(k, pairs, threads, s, p, a)
             : launch_batch_mode<false>(k, pairs, threads, s, p, a);
}
