// General-scoring strip fills: any integer scoring, linear or affine
// (Gotoh) gaps, pair scoring or a substitution matrix of up to 16 codes,
// global / local (Smith-Waterman) / ends-free modes.  One template, here,
// and three entry points: band_fill and band_capture_fill (linear gaps) in
// band_fill.cu, band_capture_affine in band_capture_affine.cu, a
// translation unit of its own so that nvcc compiles its 36 kernels beside
// the other 80 (all in one file took 20 s to build, against 12 s).
//
// band_fill (CAPTURE = false) replaces the TPU kernel
// tpualign/ops/band.py:_band_kernel_body (K6).  Contract, cell for cell the
// same as score_plain in tpualign_torch/ops/band.py:
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
// band_capture_fill and band_capture_affine (CAPTURE = true) replace
// tpualign/ops/band_align.py:_strip_kernel_body (K7) as the alignment paths
// use it: the same fill with the same flags (local, zr, zc; affine in the
// second), and, in place of the score, cell for cell the same as
// capture_plain in ops/band.py:
//
//   in:  cap_rows (J,)     int32 DP rows in 1..n, strictly increasing (the
//                          last row is row n: the caller captures it)
//        tb                affine: the top edge's vertical-gap open, in
//                          [open, 0] (Myers-Miller waives it with 0):
//                          F(0, j) = H(0, j) + tb, H(i, 0) = tb + i*ext
//   out: caps     (J, m+1) int32, caps[s][j] = H(cap_rows[s], j)
//        col      (n+1,)   int32, the last column H(0..n, m) (optional)
//        cell     (3,)     int32 (v, i, j): the max over cells i >= 1,
//                          j >= 1, first in row-major order (optional)
//        fout     (m+1,)   int32, affine: the last row F(n, 0..m), F(n, 0)
//                          taken as H(n, 0)
//   scratch: boundary (m+1,) int32 ((2, m+1) affine)
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
// The captures: at a strip's start each thread finds its captured rows in
// cap_rows by binary search (a bit mask over its K rows and the slot of the
// first) and stores H of each as its column is computed, so any row can be
// captured, a strip's last row included; the last row is row n captured.
// F runs down a thread's rows in one register, so the thread that owns row
// n keeps F as that row passes (a select a cell, affine captures only) and
// stores it with the column.
// Locating (a template flag, so that fills that do not locate carry no
// cell code): per step each thread takes its column's first maximum over
// its rows (one DPX __vibmax_s32 and a select a cell), then keeps the best
// cell, a tie replacing only from a smaller row, since its columns arrive
// in order; the block reduces by the same order.
//
// The TPU kernels' layout (column-major 8x128 planes, 2-step lane
// stagger, pend rings, SMEM boundary row and 4-bit text with its length
// cap, float32 values, sentinel pad codes, bottom-aligned strips with a
// first live slot, per-slot running max planes and right-column capture
// planes) has no counterpart here.
//
// What bounds it: one SM issues every cell (about 8 integer instructions a
// cell, DPX add-max where it fits, two more for the located cell) plus a
// block barrier per step; the other SMs idle.  Later work: a strip
// pipeline over many blocks (each block a strip, handing its bottom row
// down through global memory with flags).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kMaxCodes = 16;
constexpr int32_t kNeg = -(1 << 30);
constexpr int kNoRow = 0x7fffffff;  // no located cell yet

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

// band_capture_fill's outputs, a kernel argument of their own: with them in
// Params, ptxas spilled 208 bytes (not 24) in band_fill's global affine
// instantiations at 16 rows a thread, which doubled their time on the H100
struct CaptureArgs {
  const int32_t* cap_rows;  // (J,) captured DP rows, increasing
  int J;
  int32_t* caps;  // (J, m+1)
  int32_t* col;   // (n+1,) last column, or null
  int32_t* cell;  // (3,) located cell, or null
  int tb;         // affine: the top edge's vertical-gap open
  int32_t* fout;  // (m+1,) affine: F(n, 0..m)
};

// h[q] for a q known only at run time, without indexing a register array
template <int K>
__device__ __forceinline__ int32_t pick(const int32_t (&h)[K], int q) {
  int32_t v = h[0];
#pragma unroll
  for (int x = 1; x < K; ++x) v = x == q ? h[x] : v;
  return v;
}

// The fill, inlined into both kernels below
template <int K, bool AFFINE, bool MATRIX, bool LOCAL, bool CAPTURE, bool LOCATE>
__device__ __forceinline__ void fill(const Params& p, const CaptureArgs& c) {
  __shared__ int32_t mat[kMaxCodes * kMaxCodes];
  __shared__ int32_t hand_h[2][kWarps];
  __shared__ int32_t hand_f[2][kWarps];
  __shared__ int32_t red[LOCATE ? 3 : 1][kWarps];
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int m = p.m;
  const int n = p.n;
  const bool zr = p.flags & kZeroRow, zc = p.flags & kZeroCol;
  const bool er = p.flags & kEndRow, ec = p.flags & kEndCol;
  const bool want_col = CAPTURE && c.col != nullptr;

  if (MATRIX) {
    for (int x = r; x < p.K * p.K; x += T) mat[x] = p.matrix[x];
  }
  // strip 0's boundary: H(0, j) = j*gap, open + j*ext (affine), 0 (local,
  // zr, j = 0); F(0, j) = -inf (no gap above row 0), H(0, j) + tb in the
  // capture fill (row 1's F opens at tb: tb = open is the same fill)
  for (int j = r; j <= m; j += T) {
    int32_t v = 0;
    if (!(LOCAL || zr || j == 0)) v = AFFINE ? p.open + j * p.ext : j * p.gap;
    p.bh[j] = v;
    if (AFFINE) p.bf[j] = CAPTURE ? v + c.tb : kNeg;
    if (want_col && j == m) c.col[0] = v;
  }
  __syncthreads();

  int32_t acc = LOCAL ? 0 : kNeg;
  int32_t best_v = kNeg;  // this thread's located cell
  int best_i = kNoRow, best_j = 0;
  const int R = K * T;
  for (int i0 = 0; i0 < n; i0 += R) {
    const int top = i0 + r * K;  // this thread's rows are top+1 .. top+K
    const int nlive = max(0, min(K, n - top));
    const int t_live = (min(R, n - i0) + K - 1) / K;  // threads with a live row
    const bool owns_n = !CAPTURE && top < n && n <= top + K;
    const int qn = n - top - 1;
    // affine captures: the q of row n in the thread that owns it, else -1
    const int qf = (CAPTURE && AFFINE && top < n && n <= top + K) ? qn : -1;
    // captured rows among top+1 .. top+nlive: bit q of cmask is row top+q+1,
    // whose slot is cfirst plus the set bits below q
    unsigned cmask = 0;
    int cfirst = 0;
    if (CAPTURE) {
      int lo = 0, hi = c.J;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (c.cap_rows[mid] <= top) lo = mid + 1; else hi = mid;
      }
      cfirst = lo;
      for (int x = lo; x < c.J && c.cap_rows[x] <= top + nlive; ++x) {
        cmask |= 1u << (c.cap_rows[x] - top - 1);
      }
    }
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
      int32_t fn = 0;  // affine captures, the owner of row n: F(n, j)
      if (active && j == 0) {
        // column 0 in closed form: H(i, 0) = i*gap, open + i*ext (affine;
        // tb + i*ext in the capture fill), 0 (local, zc); E(i, 0) = -inf
        const int open0 = CAPTURE ? c.tb : p.open;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int i = top + q + 1;
          h[q] = (LOCAL || zc) ? 0 : (AFFINE ? open0 + i * p.ext : i * p.gap);
          e[q] = kNeg;
        }
        out_h = h[K - 1];
        out_f = kNeg;
        fn = (LOCAL || zc) ? 0 : open0 + n * p.ext;  // F(n, 0) := H(n, 0)
      } else if (active) {
        const int c = p.text[j - 1];
        const int cK = MATRIX ? c * p.K : 0;
        int32_t up = in_h, upf = in_f, diag = diag_top;
        int32_t cm = kNeg;  // LOCATE: this column's max over the live rows,
        int cq = 0;         // first at row top + cq + 1
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int32_t s =
              MATRIX ? mat[cK + rc[q]] : (c == rc[q] ? p.match : p.mismatch);
          int32_t hn;
          if (AFFINE) {
            e[q] = __viaddmax_s32(h[q], p.open, e[q]) + p.ext;
            upf = __viaddmax_s32(up, p.open, upf) + p.ext;
            hn = __vimax3_s32(diag + s, e[q], upf);
            if (CAPTURE) fn = q == qf ? upf : fn;
          } else {
            hn = __viaddmax_s32(max(up, h[q]), p.gap, diag + s);
          }
          if (LOCAL) {
            hn = max(hn, 0);
            if (!CAPTURE && q < nlive) acc = max(acc, hn);
          }
          if (LOCATE && q < nlive) {
            bool keep;  // cm >= hn: a tie keeps the smaller row
            cm = __vibmax_s32(cm, hn, &keep);
            cq = keep ? cq : q;
          }
          diag = h[q];
          h[q] = hn;
          up = hn;
        }
        out_h = up;
        out_f = upf;
        if (LOCATE) {
          // row-major first: the columns arrive in order, so a tie replaces
          // only from a smaller row
          const int i = top + cq + 1;
          if (cm > best_v || (cm == best_v && i < best_i)) {
            best_v = cm;
            best_i = i;
            best_j = j;
          }
        }
        if (!LOCAL && !CAPTURE) {
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
      if (CAPTURE && active) {
        // few threads own a captured row: a loop over the set bits keeps
        // the slots' addresses out of the registers of the others
        for (unsigned mk = cmask; mk != 0u; mk &= mk - 1u) {
          const int q = __ffs(mk) - 1;
          const int slot = cfirst + __popc(cmask & ((1u << q) - 1u));
          c.caps[static_cast<size_t>(slot) * (m + 1) + j] = pick(h, q);
        }
        if (want_col && j == m) {
#pragma unroll
          for (int q = 0; q < K; ++q) {
            if (q < nlive) c.col[top + q + 1] = h[q];
          }
        }
        if (qf >= 0) c.fout[j] = fn;
      }
      diag_top = in_h;
      if (lane == 31) {
        hand_h[t & 1][warp] = out_h;
        if (AFFINE) hand_f[t & 1][warp] = out_f;
      }
      __syncthreads();
    }
  }

  if (CAPTURE) {
    if (!LOCATE) return;
    // the located cell over the block: the larger value, then the smaller row
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t ov = __shfl_down_sync(0xffffffffu, best_v, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
      if (ov > best_v || (ov == best_v && oi < best_i)) {
        best_v = ov;
        best_i = oi;
        best_j = oj;
      }
    }
    if (lane == 0) {
      red[0][warp] = best_v;
      red[1][warp] = best_i;
      red[2][warp] = best_j;
    }
    __syncthreads();
    if (r == 0) {
      for (int w = 1; w < T / 32; ++w) {
        if (red[0][w] > best_v || (red[0][w] == best_v && red[1][w] < best_i)) {
          best_v = red[0][w];
          best_i = red[1][w];
          best_j = red[2][w];
        }
      }
      c.cell[0] = best_v;
      c.cell[1] = best_i;
      c.cell[2] = best_j;
    }
    return;
  }
  // max over the block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = max(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) red[0][warp] = acc;
  __syncthreads();
  if (r == 0) {
    for (int w = 1; w < T / 32; ++w) acc = max(acc, red[0][w]);
    *p.out = acc;
  }
}

// K6's port: the score, a kernel of its own that takes Params alone.  With
// CaptureArgs as a second, unused argument ptxas allocated and ordered K6's
// SW kernel differently (the same 488 instructions) and it ran 1.7% slower
// on the H100.  Taking Params alone, its linear kernels compile to the same
// SASS as before K7's port shared the fill (tools/ab_band_fill.py compares)
template <int K, bool AFFINE, bool MATRIX, bool LOCAL>
__global__ void __launch_bounds__(kMaxThreads) band_fill_kernel(Params p) {
  fill<K, AFFINE, MATRIX, LOCAL, false, false>(p, CaptureArgs{});
}

// K7's port: the captures, under affine gaps the last row of F, and, with
// LOCATE, the located cell
template <int K, bool AFFINE, bool MATRIX, bool LOCAL, bool LOCATE>
__global__ void __launch_bounds__(kMaxThreads)
    band_capture_kernel(Params p, CaptureArgs c) {
  fill<K, AFFINE, MATRIX, LOCAL, true, LOCATE>(p, c);
}

// local affine captures stop at 8 rows a thread (band.py's max_k): at 16,
// E and the masked maximum beside H spill
template <int K, bool AFFINE, bool LOCAL, bool CAPTURE>
constexpr bool kSkipped = CAPTURE && AFFINE && LOCAL && K > 8;

template <bool AFFINE, bool MATRIX, bool LOCAL, bool CAPTURE, bool LOCATE>
int launch_k(int k, int threads, cudaStream_t s, const Params& p,
             const CaptureArgs& c) {
  switch (k) {
#define BAND_CASE(K)                                                          \
  case K:                                                                     \
    if constexpr (kSkipped<K, AFFINE, LOCAL, CAPTURE>) {                      \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    } else if constexpr (CAPTURE) {                                           \
      band_capture_kernel<K, AFFINE, MATRIX, LOCAL, LOCATE><<<1, threads, 0, s>>>(p, c); \
    } else {                                                                  \
      band_fill_kernel<K, AFFINE, MATRIX, LOCAL><<<1, threads, 0, s>>>(p);    \
    }                                                                         \
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

template <bool AFFINE, bool CAPTURE, bool LOCATE>
int launch_mode(int k, int threads, cudaStream_t s, const Params& p,
                const CaptureArgs& c) {
  const bool local = p.flags & kLocal;
  if (p.K > 0) {
    return local
               ? launch_k<AFFINE, true, true, CAPTURE, LOCATE>(k, threads, s, p, c)
               : launch_k<AFFINE, true, false, CAPTURE, LOCATE>(k, threads, s, p, c);
  }
  return local
             ? launch_k<AFFINE, false, true, CAPTURE, LOCATE>(k, threads, s, p, c)
             : launch_k<AFFINE, false, false, CAPTURE, LOCATE>(k, threads, s, p, c);
}

bool bad_geometry(int m, int n, int K, int threads) {
  return m < 1 || n < 1 || K < 0 || K > kMaxCodes || threads < 32 ||
         threads > kMaxThreads || threads % 32 != 0;
}

}  // namespace
