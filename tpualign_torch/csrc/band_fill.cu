// Entry points band_fill (K6's port) and band_capture_fill (K7's, linear
// gaps) over the pipelined strip fill of band_fill.cuh, which states their
// contract and schedule.

#include "band_fill.cuh"

// Launches the pipelined band fill on `stream`: `blocks` blocks of
// `threads` threads (a multiple of 32, at most 256) of k rows each (k in
// {1, 2, 4, 8, 16}), S = ceil(n / (k*threads)) strips; K = 0 scores with
// match / mismatch, 1 <= K <= 16 with `matrix`.  `ring` is (depth, 1 or 2
// (affine), m+1) int32 scratch, depth >= 2, when S >= 2 (else unused);
// `sync` is (S + 2,) int32, zeroed.  The score maxes into out[0], which
// the caller fills with 0 (local) or -2^30.  Returns the cudaError_t of
// the launch; the fill itself runs asynchronously.
extern "C" int band_fill(const void* text, int m, const void* query, int n,
                         const void* matrix, int K, int match, int mismatch,
                         int gap, int gap_open, int gap_extend, int flags,
                         int k, int threads, int blocks, void* ring, int depth,
                         void* sync, void* out, void* stream) {
  Pipe q;
  if (!pipe_args(m, n, K, k, threads, blocks, ring, depth, sync, nullptr, false, q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const int8_t*>(text),
                 m,
                 static_cast<const int8_t*>(query),
                 n,
                 static_cast<const int32_t*>(matrix),
                 K,
                 match,
                 mismatch,
                 gap,
                 gap_open,
                 gap_extend,
                 flags,
                 static_cast<int32_t*>(out)};
  const CaptureArgs c{};
  auto s = static_cast<cudaStream_t>(stream);
  return (flags & kAffine) ? launch_mode<true, false, false>(k, threads, blocks, s, p, c, q)
                           : launch_mode<false, false, false>(k, threads, blocks, s, p, c, q);
}

// Launches the pipelined capture fill (linear gaps; flags: local, zr, zc)
// on `stream`, geometry, scoring, `ring` and `sync` as band_fill.
// Captures H of the J rows `cap_rows` (int32, strictly increasing, in
// 1..n) into `caps` (J, m+1) int32; writes the last column H(0..n, m) into
// `col` (n+1,) int32 and the located cell (v, i, j) into `cell` (3,) int32
// unless they are null; with `cell`, `cells` is (blocks, 3) int32 scratch.
// Returns the cudaError_t of the launch; the fill itself runs
// asynchronously.
extern "C" int band_capture_fill(const void* text, int m, const void* query,
                                 int n, const void* matrix, int K, int match,
                                 int mismatch, int gap, int flags, int k,
                                 int threads, int blocks, const void* cap_rows,
                                 int J, void* caps, void* col, void* cell,
                                 void* ring, int depth, void* sync, void* cells,
                                 void* stream) {
  Pipe q;
  if (!pipe_args(m, n, K, k, threads, blocks, ring, depth, sync, cells, cell != nullptr, q) ||
      (flags & kAffine) || J < 0 || (J > 0 && (cap_rows == nullptr || caps == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const int8_t*>(text),
                 m,
                 static_cast<const int8_t*>(query),
                 n,
                 static_cast<const int32_t*>(matrix),
                 K,
                 match,
                 mismatch,
                 gap,
                 0,
                 0,
                 flags,
                 nullptr};
  const CaptureArgs c{static_cast<const int32_t*>(cap_rows), J,
                      static_cast<int32_t*>(caps), static_cast<int32_t*>(col),
                      static_cast<int32_t*>(cell), 0, nullptr};
  auto s = static_cast<cudaStream_t>(stream);
  return cell ? launch_mode<false, true, true>(k, threads, blocks, s, p, c, q)
              : launch_mode<false, true, false>(k, threads, blocks, s, p, c, q);
}
