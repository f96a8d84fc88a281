// Entry point band_capture_edge: K7's sharded contract, the linear capture
// fill of band_fill.cuh (which states the contract) with the block's top
// row and left column in, in place of the table's edges in closed form
// (tpualign/ops/band_align.py: the boundary row b_in and the chunked head
// column of _strip_kernel_body, which parallel/band_strips.py feeds from
// the shard's own bottom row and the left neighbour's right column).  A
// translation unit of its own, so that nvcc builds its 40 kernels beside
// the others.

#include "band_fill.cuh"

namespace {

template <bool MATRIX, bool LOCAL, bool LOCATE>
int launch_edge(int k, int threads, int blocks, cudaStream_t s, const Params& p,
                const CaptureArgs& c, const Edge& e, const Pipe& q) {
  switch (k) {
#define EDGE_CASE(K)                                                             \
  case K:                                                                        \
    band_edge_kernel<K, MATRIX, LOCAL, LOCATE><<<blocks, threads, 0, s>>>(p, c, e, q); \
    break;
    EDGE_CASE(1)
    EDGE_CASE(2)
    EDGE_CASE(4)
    EDGE_CASE(8)
    EDGE_CASE(16)
#undef EDGE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool LOCATE>
int launch_edge_mode(int k, int threads, int blocks, cudaStream_t s, const Params& p,
                     const CaptureArgs& c, const Edge& e, const Pipe& q) {
  const bool local = p.flags & kLocal;
  if (p.K > 0) {
    return local ? launch_edge<true, true, LOCATE>(k, threads, blocks, s, p, c, e, q)
                 : launch_edge<true, false, LOCATE>(k, threads, blocks, s, p, c, e, q);
  }
  return local ? launch_edge<false, true, LOCATE>(k, threads, blocks, s, p, c, e, q)
               : launch_edge<false, false, LOCATE>(k, threads, blocks, s, p, c, e, q);
}

}  // namespace

// Launches the capture fill of band_capture_fill (linear gaps; flags:
// local) with the edges in: `top` (m+1,) int32 is H(0, 0..m) and `left`
// (n+1,) int32 is H(0..n, 0), top[0] == left[0], both on the device and
// whole before the launch.  The local floor applies to the cells i, j >= 1
// only: the edges are taken as they are.  Arguments and outputs otherwise
// as band_capture_fill's (col[0] is top[m]).  Returns the cudaError_t of
// the launch; the fill itself runs asynchronously.
extern "C" int band_capture_edge(const void* text, int m, const void* query,
                                 int n, const void* matrix, int K, int match,
                                 int mismatch, int gap, int flags, int k,
                                 int threads, int blocks, const void* cap_rows,
                                 int J, void* caps, void* col, void* cell,
                                 const void* top, const void* left, void* ring,
                                 int depth, void* sync, void* cells, void* stream) {
  Pipe q;
  if (!pipe_args(m, n, K, k, threads, blocks, ring, depth, sync, cells, cell != nullptr, q) ||
      (flags & kAffine) || J < 0 || (J > 0 && (cap_rows == nullptr || caps == nullptr)) ||
      top == nullptr || left == nullptr) {
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
  const Edge e{static_cast<const int32_t*>(top), static_cast<const int32_t*>(left)};
  auto s = static_cast<cudaStream_t>(stream);
  return cell ? launch_edge_mode<true>(k, threads, blocks, s, p, c, e, q)
              : launch_edge_mode<false>(k, threads, blocks, s, p, c, e, q);
}
