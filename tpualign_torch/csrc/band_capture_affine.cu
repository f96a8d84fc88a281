// Entry point band_capture_affine: K7's port under affine (Gotoh) gaps, the
// capture fill of band_fill.cuh (which states the contract) with the last
// row of F and the top-edge open tb, for Myers-Miller and the affine
// locates.  A translation unit of its own: nvcc builds its 36 kernels
// (local affine stops at 8 rows a thread) beside band_fill.cu's 80.

#include "band_fill.cuh"

// Launches the affine capture fill (flags: local, zr, zc; the affine flag
// set) on `stream`, geometry and scoring as band_fill, k at most 8 when
// local.  Captures H of the J rows `cap_rows` (int32, strictly increasing,
// in 1..n, row n last) into `caps` (J, m+1) int32; writes the last column
// H(0..n, m) into `col` (n+1,) int32 and the located cell (v, i, j) into
// `cell` (3,) int32 unless they are null, and F(n, 0..m) into `fout`
// (m+1,) int32.  `tb` in [gap_open, 0] is the top edge's vertical-gap
// open.  `blocks`, `ring` (H then F a slot), `sync` and `cells` as
// band_capture_fill.  Returns the cudaError_t of the launch; the fill
// itself runs asynchronously.
extern "C" int band_capture_affine(const void* text, int m, const void* query,
                                   int n, const void* matrix, int K, int match,
                                   int mismatch, int gap_open, int gap_extend,
                                   int tb, int flags, int k, int threads,
                                   int blocks, const void* cap_rows, int J,
                                   void* caps, void* col, void* cell, void* fout,
                                   void* ring, int depth, void* sync,
                                   void* cells, void* stream) {
  Pipe q;
  if (!pipe_args(m, n, K, k, threads, blocks, ring, depth, sync, cells, cell != nullptr, q) ||
      !(flags & kAffine) || J < 1 ||
      cap_rows == nullptr || caps == nullptr || fout == nullptr ||
      tb < gap_open || tb > 0) {
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
                 0,
                 gap_open,
                 gap_extend,
                 flags,
                 nullptr,
                 nullptr,
                 nullptr};
  const CaptureArgs c{static_cast<const int32_t*>(cap_rows), J,
                      static_cast<int32_t*>(caps), static_cast<int32_t*>(col),
                      static_cast<int32_t*>(cell), tb, static_cast<int32_t*>(fout)};
  auto s = static_cast<cudaStream_t>(stream);
  return cell ? launch_mode<true, true, true>(k, threads, blocks, s, p, c, q)
              : launch_mode<true, true, false>(k, threads, blocks, s, p, c, q);
}
