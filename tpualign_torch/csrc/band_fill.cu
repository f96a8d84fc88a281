// General-scoring score in row strips: any integer scoring, linear or
// affine (Gotoh) gaps, pair scoring or a substitution matrix of up to 16
// codes, global / local (Smith-Waterman) / ends-free modes.
//
// Replaces the TPU kernel tpualign/ops/band.py:_band_kernel_body (K6).
// Contract, cell for cell the same as score_plain in
// tpualign_torch/ops/band.py:
//
//   in:  text    (m,)     int8 codes, across the columns
//        query   (n,)     int8 codes, down the rows
//        matrix  (K*K,)   int32, matrix[a*K + b] scores text code a against
//                         row code b (K = 0: match / mismatch)
//        flags            local, affine, zr (H(0, j) = 0), zc (H(i, 0) = 0),
//                         er (max over row n), ec (max over column m)
//   out: out     (1,)     int32: local, the max over cells 1 <= j <= m and
//                         0; with er / ec, the max over row n (j in 1..m) /
//                         column m (i in 1..n); otherwise H(n, m)
//   scratch: boundary (2, m+1) int32, the rows H(i0, 0..m) and F(i0, 0..m)
//
// Recurrence (tpualign/ops/oracle.py): linear H = max(diag + s, up + g,
// left + g); affine E = max(left_H + open, left_E) + ext, F = max(up_H +
// open, up_F) + ext, H = max(diag + s, E, F); local floors H at 0.
//
// Schedule: one thread block of T threads (a multiple of 32).  The table
// runs in strips of R = K*T rows; thread r owns rows i0 + rK + 1 ..
// i0 + rK + K of a strip and keeps their H (and E) in registers.  At step t
// thread r computes column j = t - r of its rows, top down.  Its top row
// takes H (and F) of the row above at column j from thread r-1's bottom row,
// computed one step earlier: by __shfl_up_sync inside a warp and through a
// parity double buffer in shared memory across warps; the diagonal is the
// same value one step older.  Thread 0 reads the boundary row, the last
// thread writes its bottom row back as the next strip's boundary, T-1
// columns behind the reads, so one buffer serves in place.  Column 0 is
// injected in closed form; F at column 0 is never read.  One
// __syncthreads() per step.
//
// The TPU kernel's layout (column-major 8x128 planes, 2-step lane
// stagger, pend rings, SMEM boundary row and 4-bit text with its length
// cap, float32 values, sentinel pad codes) has no counterpart here.
//
// What bounds it: one SM issues every cell (about 8 integer instructions a
// cell, DPX add-max where it fits) plus a block barrier per step; the
// other SMs idle.  Later work: a strip pipeline over many blocks (each
// block a strip, handing its bottom row down through global memory with
// flags).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kMaxCodes = 16;
constexpr int32_t kNeg = -(1 << 30);

enum : int {
  kLocal = 1,
  kAffine = 2,
  kZeroRow = 4,
  kZeroCol = 8,
  kEndRow = 16,
  kEndCol = 32,
};

struct Params {
  const int8_t* text;
  int m;
  const int8_t* query;
  int n;
  const int32_t* matrix;
  int K;
  int match, mismatch, gap, open, ext;
  int flags;
  int32_t* bh;  // boundary row H(i0, 0..m)
  int32_t* bf;  // boundary row F(i0, 0..m), affine only
  int32_t* out;
};

// h[q] for a q known only at run time, without indexing a register array
template <int K>
__device__ __forceinline__ int32_t pick(const int32_t (&h)[K], int q) {
  int32_t v = h[0];
#pragma unroll
  for (int x = 1; x < K; ++x) v = x == q ? h[x] : v;
  return v;
}

template <int K, bool AFFINE, bool MATRIX, bool LOCAL>
__global__ void __launch_bounds__(kMaxThreads) band_fill_kernel(Params p) {
  __shared__ int32_t mat[kMaxCodes * kMaxCodes];
  __shared__ int32_t hand_h[2][kWarps];
  __shared__ int32_t hand_f[2][kWarps];
  __shared__ int32_t red[kWarps];
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int m = p.m;
  const int n = p.n;
  const bool zr = p.flags & kZeroRow, zc = p.flags & kZeroCol;
  const bool er = p.flags & kEndRow, ec = p.flags & kEndCol;

  if (MATRIX) {
    for (int x = r; x < p.K * p.K; x += T) mat[x] = p.matrix[x];
  }
  // strip 0's boundary: H(0, j) = j*gap, open + j*ext (affine), 0 (local,
  // zr, j = 0); F(0, j) = -inf (no gap above row 0)
  for (int j = r; j <= m; j += T) {
    int32_t v = 0;
    if (!(LOCAL || zr || j == 0)) v = AFFINE ? p.open + j * p.ext : j * p.gap;
    p.bh[j] = v;
    if (AFFINE) p.bf[j] = kNeg;
  }
  __syncthreads();

  int32_t acc = LOCAL ? 0 : kNeg;
  const int R = K * T;
  for (int i0 = 0; i0 < n; i0 += R) {
    const int top = i0 + r * K;  // this thread's rows are top+1 .. top+K
    const int nlive = max(0, min(K, n - top));
    const int t_live = (min(R, n - i0) + K - 1) / K;  // threads with a live row
    const bool owns_n = top < n && n <= top + K;
    const int qn = n - top - 1;
    int rc[K];
#pragma unroll
    for (int q = 0; q < K; ++q) rc[q] = q < nlive ? p.query[top + q] : 0;
    int32_t h[K], e[K];
    int32_t out_h = kNeg, out_f = kNeg, diag_top = kNeg;
    const int steps = m + t_live;
    for (int t = 0; t < steps; ++t) {
      // thread r-1's bottom row at column t - r, computed at step t - 1
      int32_t in_h = __shfl_up_sync(0xffffffffu, out_h, 1);
      int32_t in_f = AFFINE ? __shfl_up_sync(0xffffffffu, out_f, 1) : 0;
      const int j = t - r;
      const bool active = j >= 0 && j <= m && r < t_live;
      if (lane == 0 && warp > 0) {
        in_h = hand_h[(t - 1) & 1][warp - 1];
        if (AFFINE) in_f = hand_f[(t - 1) & 1][warp - 1];
      }
      if (r == 0 && active) {
        in_h = p.bh[j];
        if (AFFINE) in_f = p.bf[j];
      }
      if (active && j == 0) {
        // column 0 in closed form: H(i, 0) = i*gap, open + i*ext (affine),
        // 0 (local, zc); E(i, 0) = -inf
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int i = top + q + 1;
          h[q] = (LOCAL || zc) ? 0 : (AFFINE ? p.open + i * p.ext : i * p.gap);
          e[q] = kNeg;
        }
        out_h = h[K - 1];
        out_f = kNeg;
      } else if (active) {
        const int c = p.text[j - 1];
        const int cK = MATRIX ? c * p.K : 0;
        int32_t up = in_h, upf = in_f, diag = diag_top;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int32_t s =
              MATRIX ? mat[cK + rc[q]] : (c == rc[q] ? p.match : p.mismatch);
          int32_t hn;
          if (AFFINE) {
            e[q] = __viaddmax_s32(h[q], p.open, e[q]) + p.ext;
            upf = __viaddmax_s32(up, p.open, upf) + p.ext;
            hn = __vimax3_s32(diag + s, e[q], upf);
          } else {
            hn = __viaddmax_s32(max(up, h[q]), p.gap, diag + s);
          }
          if (LOCAL) {
            hn = max(hn, 0);
            if (q < nlive) acc = max(acc, hn);
          }
          diag = h[q];
          h[q] = hn;
          up = hn;
        }
        out_h = up;
        out_f = upf;
        if (!LOCAL) {
          if (ec && j == m) {
#pragma unroll
            for (int q = 0; q < K; ++q) {
              if (q < nlive) acc = max(acc, h[q]);
            }
          }
          if (owns_n && (er || j == m)) acc = max(acc, pick(h, qn));
        }
      }
      if (active && r == T - 1) {  // the next strip's boundary
        p.bh[j] = out_h;
        if (AFFINE) p.bf[j] = out_f;
      }
      diag_top = in_h;
      if (lane == 31) {
        hand_h[t & 1][warp] = out_h;
        if (AFFINE) hand_f[t & 1][warp] = out_f;
      }
      __syncthreads();
    }
  }

  // max over the block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = max(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (r == 0) {
    for (int w = 1; w < T / 32; ++w) acc = max(acc, red[w]);
    *p.out = acc;
  }
}

template <bool AFFINE, bool MATRIX, bool LOCAL>
int launch_k(int k, int threads, cudaStream_t s, const Params& p) {
  switch (k) {
#define BAND_CASE(K)                                                       \
  case K:                                                                  \
    band_fill_kernel<K, AFFINE, MATRIX, LOCAL><<<1, threads, 0, s>>>(p);   \
    break;
    BAND_CASE(1)
    BAND_CASE(2)
    BAND_CASE(4)
    BAND_CASE(8)
    BAND_CASE(16)
#undef BAND_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool AFFINE>
int launch_mode(int k, int threads, cudaStream_t s, const Params& p) {
  const bool local = p.flags & kLocal;
  if (p.K > 0) {
    return local ? launch_k<AFFINE, true, true>(k, threads, s, p)
                 : launch_k<AFFINE, true, false>(k, threads, s, p);
  }
  return local ? launch_k<AFFINE, false, true>(k, threads, s, p)
               : launch_k<AFFINE, false, false>(k, threads, s, p);
}

}  // namespace

// Launches the band fill on `stream` with `threads` threads (a multiple of
// 32, at most 1024) of k rows each (k in {1, 2, 4, 8, 16}); K = 0 scores
// with match / mismatch, 1 <= K <= 16 with `matrix`.  `boundary` is
// (2, m+1) int32 scratch; the score lands in out[0].  Returns the
// cudaError_t of the launch; the fill itself runs asynchronously.
extern "C" int band_fill(const void* text, int m, const void* query, int n,
                         const void* matrix, int K, int match, int mismatch,
                         int gap, int gap_open, int gap_extend, int flags,
                         int k, int threads, void* boundary, void* out,
                         void* stream) {
  if (m < 1 || n < 1 || K < 0 || K > kMaxCodes || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* b = static_cast<int32_t*>(boundary);
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
                 b,
                 b + m + 1,
                 static_cast<int32_t*>(out)};
  auto s = static_cast<cudaStream_t>(stream);
  return (flags & kAffine) ? launch_mode<true>(k, threads, s, p)
                           : launch_mode<false>(k, threads, s, p);
}
