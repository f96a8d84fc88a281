// General-scoring strip fills: any integer scoring, linear or affine
// (Gotoh) gaps, pair scoring or a substitution matrix of up to 16 codes,
// global / local (Smith-Waterman) / ends-free modes.  One strip body, here,
// two schedules over it, and four entry points: band_fill and
// band_capture_fill (linear gaps) in band_fill.cu, band_capture_affine in
// band_capture_affine.cu, a translation unit of its own so that nvcc
// compiles its 36 kernels beside the other 80 (all in one file took 20 s
// to build, against 12 s); band_batch.cu runs the in-place schedule;
// diag_ckpt.cu runs K9's checkpoint contract (CKPT, stated there) and
// diag_fill.cu K8's score (band_fill's under pair scoring and linear gaps)
// on the pipelined schedule.
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
//                         column m (i in 1..n); otherwise H(n, m).  The
//                         caller fills it with the max's identity (0
//                         local, kNeg otherwise): each block maxes into it
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
//
// Recurrence (tpualign/ops/oracle.py): linear H = max(diag + s, up + g,
// left + g); affine E = max(left_H + open, left_E) + ext, F = max(up_H +
// open, up_F) + ext, H = max(diag + s, E, F); local floors H at 0.
//
// The strip body (strip): a thread block of T threads (a multiple of 32)
// fills R = K*T rows; thread r owns rows i0 + rK + 1 .. i0 + rK + K and
// keeps their H (and E) in registers.  At step t thread r computes column
// j = t - r of its rows, top down.  Its top row takes H (and F) of the row
// above at column j from thread r-1's bottom row, computed one step
// earlier: by __shfl_up_sync inside a warp and through a parity double
// buffer in shared memory across warps; the diagonal is the same value one
// step older.  Thread 0 reads the strip's input row, the last thread
// writes its bottom row as the next strip's input, T-1 columns behind.
// Column 0 is injected in closed form; F at column 0 is never read.  One
// __syncthreads() per step.
//
// The pipelined schedule (fill_pipe: band_fill's, the capture fills',
// diag_fill's and diag_ckpt_fill's kernels): S = ceil(n/R) strips over G blocks of one
// launch.  A block takes strip numbers in order from an atomic ticket,
// never from blockIdx, so it only ever waits on a lower strip, which a
// running block holds: no grid size deadlocks, and blocks need not be
// co-resident.  With
// G = 1 one block walks every strip, the single-block schedule.  Strips
// hand their bottom rows down through a ring of D slots of (m+1) int32 H
// (then F under affine gaps) in global memory: strip s reads slot (s-1)
// mod D and writes slot s mod D.  Its last thread publishes progress[s] =
// j+1 with release semantics every kPublish columns and at column m;
// warp 0 of strip s+1 brings that row into shared memory a chunk of
// kChunk columns at a time, the next chunk's loads in flight while
// thread 0 reads the current one, so no step waits on L2: before it loads
// columns up to j, each lane waits with acquire until progress[s] > j
// (keeping the last value seen, so it polls once a chunk at most), and it
// loads through L2 (__ldcg: L1 may hold a line from the slot's last use).
// Before it writes column j of a reused slot, the last thread waits until
// progress[s-D+1] > j, the strip that read the slot's old row; with that
// backpressure any D >= 2 is correct.  Strip 0 computes its top row in
// closed form (an input pointer of null: a later boundary row in can take
// its place).  The score maxes into out with
// atomicMax; the located cell goes per block into a (G, 3) array, and the
// last block to finish (a done counter after a fence) reduces it by the
// larger value, then the smaller row: a row belongs to one strip, so the
// row-major first maximum is kept.  Captures, the last column and F's
// last row are written by each row's owner.
//
// The in-place schedule (fill_inplace: band_batch_kernel, one block a
// pair): one block walks the strips through one boundary row in place
// (thread 0 reads column j, the last thread writes it T-1 steps later),
// after a pre-pass that writes strip 0's boundary.
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
// in order; the blocks reduce by the same order.
//
// The TPU kernels' layout (column-major 8x128 planes, 2-step lane
// stagger, pend rings, SMEM boundary row and 4-bit text with its length
// cap, float32 values, sentinel pad codes, bottom-aligned strips with a
// first live slot, per-slot running max planes and right-column capture
// planes) has no counterpart here; their strips run in order on one core,
// here they run side by side, each a column-skew behind the strip above.
//
// What bounds it: the pipeline runs about m + T + (S-1)(T + 2 kChunk)
// steps when G >= S (a block walks ceil(S/G) strips otherwise), each step
// K cells a thread (about 8 integer instructions a cell, DPX add-max
// where it fits, two more for the located cell) plus a block barrier;
// the ramp of S strips, each starting about T + 2 kChunk columns behind
// the one above, and the per-step latency of a small block set the time,
// not the card's integer rate.

#pragma once

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;  // the in-place schedule (the batch)
constexpr int kPipeThreads = 256;  // the pipelined fills' blocks
constexpr int kWarps = kMaxThreads / 32;
constexpr int kMaxCodes = 16;
constexpr int32_t kNeg = -(1 << 30);
constexpr int kNoRow = 0x7fffffff;  // no located cell yet
constexpr int kPublish = 32;        // columns between two progress flags
constexpr int kChunk = 32;          // columns a fetch of the input row: one a lane
static_assert(kChunk == 32, "warp 0 fetches a chunk of kChunk columns, one a lane");

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
  int32_t* bh;  // in place: boundary row H(i0, 0..m)
  int32_t* bf;  // in place: boundary row F(i0, 0..m), affine only
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

// diag_ckpt_fill's outputs (CKPT, K9's contract in diag_ckpt.cu): every
// slot written by the kernel, each by the owner of its row
struct CkptArgs {
  int32_t* cka;    // (groups, n+1): cka[c][i] = H(i, c*every - i)
  int32_t* ckb;    // (groups, n+1): ckb[c][i] = H(i, c*every - 1 - i)
  int32_t* v;      // (n+1,) local: row i's max over j >= 1, floored at 0
  int32_t* dbest;  // (n+1,) local: the first diagonal that reached it, or 0
  int every;       // the checkpoint stride (the contract's K), >= 8
  int groups;      // ceil((n + m) / every)
};

// The pipeline's scratch, zeroed by the caller where it says so
struct Pipe {
  int32_t* ring;    // (depth, 1 or 2, m+1): H, then F under affine gaps
  int* sync;        // zeroed (strips + 2,): ticket, blocks done, progress[s]
  int32_t* blocks;  // (gridDim.x, 3) each block's located cell (LOCATE)
  int strips;       // S = ceil(n / R)
  int depth;        // D, at least 2 when S >= 2
};

// One strip's rows in and out.  In place: in and out are one boundary row
// and the flags are null.  Pipelined: in is the ring slot of the strip
// above (null for strip 0: the table's top edge in closed form), out this
// strip's slot (null for the last strip), with their progress flags
struct Link {
  const int32_t* in_h;
  const int32_t* in_f;
  int32_t* out_h;
  int32_t* out_f;
  int* in_ready;  // progress of the strip above: columns of in published
  int* out_ready;  // this strip's progress
  int* out_free;   // progress of the strip that read out's slot last, or null
};

__device__ __forceinline__ int load_acquire(int* flag) {
  return cuda::atomic_ref<int, cuda::thread_scope_device>(*flag).load(
      cuda::std::memory_order_acquire);
}

__device__ __forceinline__ void store_release(int* flag, int v) {
  cuda::atomic_ref<int, cuda::thread_scope_device>(*flag).store(
      v, cuda::std::memory_order_release);
}

// h[q] for a q known only at run time, without indexing a register array
template <int K>
__device__ __forceinline__ int32_t pick(const int32_t (&h)[K], int q) {
  int32_t v = h[0];
#pragma unroll
  for (int x = 1; x < K; ++x) v = x == q ? h[x] : v;
  return v;
}

// H(0, j) of the table's top edge: j*gap, open + j*ext (affine), 0 (local,
// zr, j = 0); F(0, j) = -inf (no gap above row 0), H(0, j) + tb in the
// capture fill (row 1's F opens at tb: tb = open is the same fill)
template <bool AFFINE, bool LOCAL, bool CAPTURE>
__device__ __forceinline__ int32_t top_h(const Params& p, int j) {
  const bool zr = p.flags & kZeroRow;
  if (LOCAL || zr || j == 0) return 0;
  return AFFINE ? p.open + j * p.ext : j * p.gap;
}

// One strip: rows i0+1 .. min(i0 + K*blockDim.x, n), its top row from
// l.in_h (and l.in_f), its bottom row to l.out_h (and l.out_f).  acc is
// the score's running max, best_* the thread's located cell, both carried
// across the block's strips.  PIPE: the progress flags and the closed-form
// top edge (see the header).  CKPT: K9's checkpoints in place of the
// score (linear gaps, pair scoring)
template <int K, bool AFFINE, bool MATRIX, bool LOCAL, bool CAPTURE, bool LOCATE,
          bool PIPE, bool CKPT>
__device__ __forceinline__ void strip(const Params& p, const CaptureArgs& c,
                                      const CkptArgs& ck, const int32_t* mat, int i0,
                                      const Link& l, int32_t& acc, int32_t& best_v,
                                      int& best_i, int& best_j) {
  __shared__ int32_t hand_h[2][kWarps];
  __shared__ int32_t hand_f[2][kWarps];
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int m = p.m;
  const int n = p.n;
  const bool zc = p.flags & kZeroCol;
  const bool er = p.flags & kEndRow, ec = p.flags & kEndCol;
  const bool want_col = CAPTURE && c.col != nullptr;
  const int R = K * T;
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
  // CKPT: at column j, row qa of the thread (its row top + qa + 1) is the
  // first on a diagonal c * every, c = ga, and qa - 1 (or every - 1) the
  // first on a diagonal c * every - 1; a step moves both up one row (no
  // division in the loop).  vb and jb hold each row's running max (local)
  // and the column that first reached it strictly
  int qa = 0, ga = 0;
  int32_t vb[K], jb[K];
  if (CKPT) {
    qa = (ck.every - (top + 1) % ck.every) % ck.every;
    ga = (top + 1 + qa) / ck.every;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      vb[q] = 0;
      jb[q] = 0;
    }
  }
  // PIPE: warp 0 brings the input row into in_buf a chunk of kChunk
  // columns at a time, the next chunk's loads in flight in next_h/next_f
  // for kChunk steps, so no step waits on L2 (each lane checks the flag
  // with its own acquire load, keeping the last value seen)
  __shared__ int32_t in_buf[2][kChunk];
  const bool fetch = PIPE && l.in_h != nullptr && warp == 0;
  int seen = 0;
  int32_t next_h = 0, next_f = 0;
  if (fetch) {
    const int need = min(kChunk, m + 1);
    while (seen < need) seen = load_acquire(l.in_ready);
    if (lane <= m) {
      next_h = __ldcg(l.in_h + lane);
      if (AFFINE) next_f = __ldcg(l.in_f + lane);
    }
  }
  int free_to = 0;  // PIPE, the last thread: columns of its slot known read
  int ch = 0;       // PIPE: the text code of this step's column
  const int steps = m + t_live;
  for (int t = 0; t < steps; ++t) {
    // thread r-1's bottom row at column t - r, computed at step t - 1
    int32_t in_h = __shfl_up_sync(0xffffffffu, out_h, 1);
    int32_t in_f = AFFINE ? __shfl_up_sync(0xffffffffu, out_f, 1) : 0;
    const int j = t - r;
    const bool active = j >= 0 && j <= m && r < t_live;
    if (fetch && t % kChunk == 0 && t <= m) {
      // chunk t / kChunk lands in in_buf (lane 0 reads it over the next
      // kChunk steps, and each step ends in a barrier), the next one
      // starts loading
      in_buf[0][lane] = next_h;
      if (AFFINE) in_buf[1][lane] = next_f;
      if (t + kChunk <= m) {
        const int need = min(t + 2 * kChunk, m + 1);
        while (seen < need) seen = load_acquire(l.in_ready);
        const int jn = t + kChunk + lane;
        if (jn <= m) {
          next_h = __ldcg(l.in_h + jn);
          if (AFFINE) next_f = __ldcg(l.in_f + jn);
        }
      }
    }
    if (lane == 0 && warp > 0) {
      in_h = hand_h[(t - 1) & 1][warp - 1];
      if (AFFINE) in_f = hand_f[(t - 1) & 1][warp - 1];
    }
    if (r == 0 && active) {
      if (PIPE && l.in_h == nullptr) {
        in_h = top_h<AFFINE, LOCAL, CAPTURE>(p, j);
        if (AFFINE) in_f = CAPTURE ? in_h + c.tb : kNeg;
        if (want_col && j == m) c.col[0] = in_h;
      } else if (PIPE) {
        in_h = in_buf[0][j % kChunk];
        if (AFFINE) in_f = in_buf[1][j % kChunk];
      } else {
        in_h = l.in_h[j];
        if (AFFINE) in_f = l.in_f[j];
      }
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
      const int c = PIPE ? ch : p.text[j - 1];
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
          if (!CAPTURE && !CKPT && q < nlive) acc = max(acc, hn);
        }
        if (CKPT && LOCAL) {
          bool keep;  // vb >= hn: a tie keeps the earlier column
          vb[q] = __vibmax_s32(vb[q], hn, &keep);
          jb[q] = keep ? jb[q] : j;
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
      if (!LOCAL && !CAPTURE && !CKPT) {
        if (ec && j == m) {
#pragma unroll
          for (int q = 0; q < K; ++q) {
            if (q < nlive) acc = max(acc, h[q]);
          }
        }
        if (owns_n && (er || j == m)) acc = max(acc, pick(h, qn));
      }
    }
    if (CKPT && active) {
      // the rows on checkpoint diagonals: qa, qa + every, ... (cka, groups
      // ga, ga + 1, ...) and qb, qb + every, ... (ckb, from gb): a few
      // steps in every, at most two rows each when every = 8 and K = 16
      const int qb = qa == 0 ? ck.every - 1 : qa - 1;
      const int gb = qa == 0 ? ga + 1 : ga;
      if (qa < K || qb < K) {
        for (int x = qa, c = ga; x < min(K, nlive) && c < ck.groups; x += ck.every, ++c) {
          ck.cka[static_cast<size_t>(c) * (n + 1) + top + x + 1] = pick(h, x);
        }
        for (int x = qb, c = gb; x < min(K, nlive) && c < ck.groups; x += ck.every, ++c) {
          ck.ckb[static_cast<size_t>(c) * (n + 1) + top + x + 1] = pick(h, x);
        }
      }
      qa = qb;  // the next column's diagonals are one row higher
      ga = gb;
    }
    if (active && r == T - 1) {  // the next strip's input row
      if (PIPE) {
        if (l.out_h != nullptr) {
          if (l.out_free != nullptr && free_to <= j) {
            do {
              free_to = load_acquire(l.out_free);
            } while (free_to <= j);
          }
          __stcg(l.out_h + j, out_h);
          if (AFFINE) __stcg(l.out_f + j, out_f);
          if ((j + 1) % kPublish == 0 || j == m) store_release(l.out_ready, j + 1);
        }
      } else {
        l.out_h[j] = out_h;
        if (AFFINE) l.out_f[j] = out_f;
      }
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
    // PIPE: the next step's text code (column j + 1), a step ahead
    if (PIPE && j + 1 >= 1 && j + 1 <= m) ch = p.text[j];
    diag_top = in_h;
    if (lane == 31) {
      hand_h[t & 1][warp] = out_h;
      if (AFFINE) hand_f[t & 1][warp] = out_f;
    }
    __syncthreads();
  }
  if (CKPT) {
    // the slots whose diagonal misses row i (c * every - i or c * every -
    // 1 - i outside 0..m) get kNeg, and, local, the row's max and the
    // first diagonal that reached it, each by the row's owner; row 0, the
    // closed-form top edge, by strip 0's thread 0
    const int E = ck.every;
    const size_t S = static_cast<size_t>(n) + 1;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (q < nlive) {
        const int i = top + q + 1;
        for (int cq = 0; cq <= (i - 1) / E; ++cq) ck.cka[cq * S + i] = kNeg;
        for (int cq = (m + i) / E + 1; cq < ck.groups; ++cq) ck.cka[cq * S + i] = kNeg;
        for (int cq = 0; cq <= i / E; ++cq) ck.ckb[cq * S + i] = kNeg;
        for (int cq = (m + i + 1) / E + 1; cq < ck.groups; ++cq) ck.ckb[cq * S + i] = kNeg;
        if (LOCAL) {
          ck.v[i] = vb[q];
          ck.dbest[i] = jb[q] > 0 ? i + jb[q] : 0;
        }
      }
    }
    if (i0 == 0 && r == 0) {
      for (int cq = 0; cq < ck.groups; ++cq) {
        const int ja = cq * E, jb1 = cq * E - 1;
        ck.cka[cq * S] = ja <= m ? top_h<false, LOCAL, false>(p, ja) : kNeg;
        ck.ckb[cq * S] = (jb1 >= 0 && jb1 <= m) ? top_h<false, LOCAL, false>(p, jb1) : kNeg;
      }
      if (LOCAL) {
        ck.v[0] = 0;
        ck.dbest[0] = 0;
      }
    }
  }
}

// The block's max of acc (thread 0's value is the block's)
__device__ __forceinline__ int32_t block_max(int32_t acc, int32_t* red) {
  const int r = threadIdx.x, lane = r & 31, warp = r >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = max(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (r == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x) / 32; ++w) acc = max(acc, red[w]);
  }
  return acc;
}

// (v, i) beats (bv, bi): the larger value, then the smaller row
__device__ __forceinline__ bool better(int32_t v, int i, int32_t bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The block's located cell, in thread 0's best_*
__device__ __forceinline__ void block_cell(int32_t& best_v, int& best_i, int& best_j,
                                           int32_t (*red)[kWarps]) {
  const int r = threadIdx.x, lane = r & 31, warp = r >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t ov = __shfl_down_sync(0xffffffffu, best_v, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
    if (better(ov, oi, best_v, best_i)) {
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
    for (int w = 1; w < static_cast<int>(blockDim.x) / 32; ++w) {
      if (better(red[0][w], red[1][w], best_v, best_i)) {
        best_v = red[0][w];
        best_i = red[1][w];
        best_j = red[2][w];
      }
    }
  }
}

// The in-place schedule: one block walks every strip of one table through
// the boundary rows p.bh, p.bf (the batch kernel, one block a pair)
template <int K, bool AFFINE, bool MATRIX, bool LOCAL>
__device__ __forceinline__ void fill_inplace(const Params& p) {
  __shared__ int32_t mat[kMaxCodes * kMaxCodes];
  __shared__ int32_t red[kWarps];
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const int m = p.m;
  const bool zr = p.flags & kZeroRow;
  if (MATRIX) {
    for (int x = r; x < p.K * p.K; x += T) mat[x] = p.matrix[x];
  }
  // strip 0's boundary (top_h; F(0, j) = -inf)
  for (int j = r; j <= m; j += T) {
    int32_t v = 0;
    if (!(LOCAL || zr || j == 0)) v = AFFINE ? p.open + j * p.ext : j * p.gap;
    p.bh[j] = v;
    if (AFFINE) p.bf[j] = kNeg;
  }
  __syncthreads();
  int32_t acc = LOCAL ? 0 : kNeg;
  int32_t best_v = kNeg;
  int best_i = kNoRow, best_j = 0;
  const Link l{p.bh, p.bf, p.bh, p.bf, nullptr, nullptr, nullptr};
  for (int i0 = 0; i0 < p.n; i0 += K * T) {
    strip<K, AFFINE, MATRIX, LOCAL, false, false, false, false>(
        p, CaptureArgs{}, CkptArgs{}, mat, i0, l, acc, best_v, best_i, best_j);
  }
  acc = block_max(acc, red);
  if (r == 0) *p.out = acc;
}

// The pipelined schedule (see the header): the blocks take strips from a
// ticket and hand rows down through the ring
template <int K, bool AFFINE, bool MATRIX, bool LOCAL, bool CAPTURE, bool LOCATE,
          bool CKPT>
__device__ __forceinline__ void fill_pipe(const Params& p, const CaptureArgs& c,
                                          const Pipe& q, const CkptArgs& ck) {
  __shared__ int32_t mat[kMaxCodes * kMaxCodes];
  __shared__ int32_t red[LOCATE ? 3 : 1][kWarps];
  __shared__ int ticket;
  __shared__ bool last_block;
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const int m = p.m;
  if (MATRIX) {
    for (int x = r; x < p.K * p.K; x += T) mat[x] = p.matrix[x];
  }
  int32_t acc = LOCAL ? 0 : kNeg;
  int32_t best_v = kNeg;  // this thread's located cell
  int best_i = kNoRow, best_j = 0;
  const size_t stride = static_cast<size_t>(AFFINE ? 2 : 1) * (m + 1);
  int* progress = q.sync + 2;
  for (;;) {
    if (r == 0) ticket = atomicAdd(q.sync, 1);
    __syncthreads();
    const int s = ticket;
    __syncthreads();  // every thread has read the ticket before the next
    if (s >= q.strips) break;
    Link l{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
    if (s > 0) {
      const int32_t* row = q.ring + static_cast<size_t>((s - 1) % q.depth) * stride;
      l.in_h = row;
      l.in_f = row + m + 1;
      l.in_ready = progress + s - 1;
    }
    if (s + 1 < q.strips) {
      int32_t* row = q.ring + static_cast<size_t>(s % q.depth) * stride;
      l.out_h = row;
      l.out_f = row + m + 1;
      l.out_ready = progress + s;
      if (s >= q.depth) l.out_free = progress + s - q.depth + 1;
    }
    strip<K, AFFINE, MATRIX, LOCAL, CAPTURE, LOCATE, true, CKPT>(
        p, c, ck, mat, s * K * T, l, acc, best_v, best_i, best_j);
  }
  if (CKPT) return;  // the checkpoints are written by their rows' owners
  if (!CAPTURE) {
    acc = block_max(acc, red[0]);
    if (r == 0) atomicMax(p.out, acc);
    return;
  }
  if (!LOCATE) return;
  block_cell(best_v, best_i, best_j, red);
  if (r == 0) {
    int32_t* mine = q.blocks + 3 * static_cast<size_t>(blockIdx.x);
    mine[0] = best_v;
    mine[1] = best_i;
    mine[2] = best_j;
    __threadfence();
    last_block = atomicAdd(q.sync + 1, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last_block || r != 0) return;
  // the last block to finish: every block's cell is written and fenced
  __threadfence();
  for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
    const int32_t* other = q.blocks + 3 * static_cast<size_t>(b);
    const int32_t ov = __ldcg(other);
    const int oi = __ldcg(other + 1);
    if (better(ov, oi, best_v, best_i)) {
      best_v = ov;
      best_i = oi;
      best_j = __ldcg(other + 2);
    }
  }
  c.cell[0] = best_v;
  c.cell[1] = best_i;
  c.cell[2] = best_j;
}

// K6's port: the score, pipelined
template <int K, bool AFFINE, bool MATRIX, bool LOCAL>
__global__ void __launch_bounds__(kPipeThreads) band_fill_kernel(Params p, Pipe q) {
  fill_pipe<K, AFFINE, MATRIX, LOCAL, false, false, false>(p, CaptureArgs{}, q, CkptArgs{});
}

// K7's port: the captures, under affine gaps the last row of F, and, with
// LOCATE, the located cell, pipelined
template <int K, bool AFFINE, bool MATRIX, bool LOCAL, bool LOCATE>
__global__ void __launch_bounds__(kPipeThreads)
    band_capture_kernel(Params p, CaptureArgs c, Pipe q) {
  fill_pipe<K, AFFINE, MATRIX, LOCAL, true, LOCATE, false>(p, c, q, CkptArgs{});
}

// local affine captures stop at 8 rows a thread (band.py's max_k): at 16,
// E and the masked maximum beside H spill
template <int K, bool AFFINE, bool LOCAL, bool CAPTURE>
constexpr bool kSkipped = CAPTURE && AFFINE && LOCAL && K > 8;

template <bool AFFINE, bool MATRIX, bool LOCAL, bool CAPTURE, bool LOCATE>
int launch_k(int k, int threads, int blocks, cudaStream_t s, const Params& p,
             const CaptureArgs& c, const Pipe& q) {
  switch (k) {
#define BAND_CASE(K)                                                          \
  case K:                                                                     \
    if constexpr (kSkipped<K, AFFINE, LOCAL, CAPTURE>) {                      \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    } else if constexpr (CAPTURE) {                                           \
      band_capture_kernel<K, AFFINE, MATRIX, LOCAL, LOCATE><<<blocks, threads, 0, s>>>(p, c, q); \
    } else {                                                                  \
      band_fill_kernel<K, AFFINE, MATRIX, LOCAL><<<blocks, threads, 0, s>>>(p, q); \
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
int launch_mode(int k, int threads, int blocks, cudaStream_t s, const Params& p,
                const CaptureArgs& c, const Pipe& q) {
  const bool local = p.flags & kLocal;
  if (p.K > 0) {
    return local ? launch_k<AFFINE, true, true, CAPTURE, LOCATE>(k, threads, blocks, s, p, c, q)
                 : launch_k<AFFINE, true, false, CAPTURE, LOCATE>(k, threads, blocks, s, p, c, q);
  }
  return local ? launch_k<AFFINE, false, true, CAPTURE, LOCATE>(k, threads, blocks, s, p, c, q)
               : launch_k<AFFINE, false, false, CAPTURE, LOCATE>(k, threads, blocks, s, p, c, q);
}

bool bad_geometry(int m, int n, int K, int threads) {
  return m < 1 || n < 1 || K < 0 || K > kMaxCodes || threads < 32 ||
         threads > kMaxThreads || threads % 32 != 0;
}

// The pipeline's arguments: a geometry of at most kPipeThreads threads, k
// rows each, `blocks` blocks; the ring and the flags when S >= 2; the
// blocks' cells when locating.  Fills q, or returns false
bool pipe_args(int m, int n, int K, int k, int threads, int blocks, void* ring,
               int depth, void* sync, void* cells, bool locate, Pipe& q) {
  if (bad_geometry(m, n, K, threads) || threads > kPipeThreads || k < 1 || k > 16 ||
      blocks < 1 || sync == nullptr || (locate && cells == nullptr)) {
    return false;
  }
  const long long R = static_cast<long long>(k) * threads;
  const int strips = static_cast<int>((n + R - 1) / R);
  if (strips > 1 && (ring == nullptr || depth < 2)) return false;
  q = Pipe{static_cast<int32_t*>(ring), static_cast<int*>(sync),
           static_cast<int32_t*>(cells), strips, depth};
  return true;
}

}  // namespace
