// General-scoring strip fills: any integer scoring, linear or affine
// (Gotoh) gaps, pair scoring or a substitution matrix of up to 16 codes,
// global / local (Smith-Waterman) / ends-free modes.  One strip body, here,
// run by a block over many blocks (the pipelined schedule, fill_pipe) or by
// one warp alone (WARP), and the entry points over it: band_fill and
// band_capture_fill (linear gaps) in band_fill.cu, band_capture_affine in
// band_capture_affine.cu, a translation unit of its own so that nvcc
// compiles its 36 kernels beside the other 80 (all in one file took 20 s
// to build, against 12 s); diag_ckpt.cu runs K9's checkpoint contract
// (CKPT, stated there) and diag_fill.cu K8's score (band_fill's under pair
// scoring and linear gaps) on the pipelined schedule; band_batch.cu runs
// K7's batch contract, its long pairs' strips on a ticket of its own and
// its short pairs a warp each (stated there).
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
// __syncthreads() per step.  Under WARP one warp runs the body alone on a
// table of at most 32*K rows (T = 32, r the lane): its top row in closed
// form, no row out, no shared memory and no barrier, the shuffles its only
// synchronisation.
//
// The pipelined schedule (fill_pipe: band_fill's, the capture fills',
// diag_fill's and diag_ckpt_fill's kernels; band_batch.cu numbers the
// strips of many tables in one ticket): S = ceil(n/R) strips over G blocks of one
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
// The captures: at a strip's start each thread finds its captured rows in
// cap_rows by binary search (a bit mask over its K rows and the slot of the
// first) and stores H of each as its column is computed, so any row can be
// captured, a strip's last row included; the last row is row n captured.
// F runs down a thread's rows in one register, so the thread that owns row
// n keeps F as that row passes (a select a cell, affine captures only) and
// stores it with the column.
// The edges in (EDGE, band_capture_edge.cu: K7's sharded contract, linear
// gaps): the table is a block of a larger one, and its top row H(0, 0..m)
// and left column H(0..n, 0) (the corner in both) come in as arrays.
// Strip 0 reads the top row in place of the closed form, as a later strip
// reads the ring (warp 0 fetches it a chunk at a time, its flag always
// ready), and each thread's column 0 takes its rows of the left column in
// place of the closed form.  A template flag, so that the other fills
// carry none of it.
//
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
// K6's score (band_fill) runs a tiled body of its own (tile_strip, the
// TILE flag of fill_pipe; the other contracts keep strip): at step t
// thread r computes a K x W tile, columns (t-r)*W + 1 .. (t-r)*W + W of its
// rows (W = tile_w(K): 4 at K <= 4, 8 above), its H (and E) in registers
// across the tile.  The W values of the row above (H, and F under affine
// gaps) come from thread r-1's tile of the step before, by W shuffles
// inside a warp and through a W-wide parity double buffer across warps;
// the diagonal of the first column is the last value of the previous
// hand-off.  A cell (q, w) waits only on (q-1, w) and (q, w-1), so the
// unrolled tile holds min(K, W) chains at once.  The W text codes come in
// aligned words a step ahead (bytes at the ragged last tile and for an
// unaligned text); column 0 stays in closed form; a tile with rows past n
// or columns past m, or with cells the ends-free or global score reads,
// masks them, and every other tile feeds the local max by row.  Warp 0
// fetches the input row a chunk of kChunk columns at a time, one chunk
// every kChunk / W steps (chunk c: columns c*kChunk + 1 .. c*kChunk +
// kChunk); the last thread stores its W bottom columns to the ring slot
// behind the same backpressure, and publishes the columns of the step
// before each kPublish boundary (its fence then finds them drained), and m
// + 1 after its last tile.  Under linear gaps a tile holds H + gap, at
// once the next row's up + gap and the next column's left + gap, so a cell
// is one DPX three-way max (with the local floor) and the score comes less
// the gap.
//
// What bounds it: the tiled pipeline runs ceil(S/G)(ceil(m/W) + T) + (G -
// 1)(T + 2 kPublish / W) steps (band.py's tile_steps): 32,761 for SW at the
// 64gb shape (K = W = 8, 128 threads, 124 blocks): 15,905 tiles of a strip
// and the ramp of 123 strips, where strip's column a step ran ~151,000.  A
// step costs about 455 ns plus 6.5 ns a cell of the tile on the H100
// (band.py's TILE_STEP_NS, TILE_CELL_NS; 880 ns at K = W = 8 inside the
// pipeline):
// the shuffles, shared hand-offs, barrier and fetch are a fixed part that
// the tile pays once every W columns, and the cells run at the integer
// pipe's half rate (compare, select, the DPX max), one warp a scheduler.
// ptxas: 130 registers at SW's K = 8, 48-254 over the 40 instantiations
// (K = 16 up to 254), none spilled.
//
// What bounds the other contracts (strip): about m + T + (S-1)(T + 2
// kChunk) steps when G >= S (a block walks ceil(S/G) strips otherwise),
// each step K cells a thread (about 8 integer instructions a cell, DPX
// add-max where it fits, two more for the located cell) plus a block
// barrier; the ramp of S strips, each starting about T + 2 kChunk columns
// behind the one above, and the per-step latency of a small block set the
// time, not the card's integer rate.

#pragma once

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kPipeThreads = 256;  // the most threads a block
constexpr int kWarps = kPipeThreads / 32;
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

// EDGE: the block's edges in (see the header)
struct Edge {
  const int32_t* top;   // (m+1,) H(0, 0..m)
  const int32_t* left;  // (n+1,) H(0..n, 0)
};

// EDGE: the progress of the top row in, which is whole before the launch
__device__ int kEdgeReady = 0x7fffffff;

// The pipeline's scratch, zeroed by the caller where it says so
struct Pipe {
  int32_t* ring;    // (depth, 1 or 2, m+1): H, then F under affine gaps
  int* sync;        // zeroed (strips + 2,): ticket, blocks done, progress[s]
  int32_t* blocks;  // (gridDim.x, 3) each block's located cell (LOCATE)
  int strips;       // S = ceil(n / R)
  int depth;        // D, at least 2 when S >= 2
};

// One strip's rows in and out: in is the ring slot of the strip above (null
// for strip 0: the table's top edge in closed form), out this strip's slot
// (null for the last strip), with their progress flags
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
// across the block's strips.  CKPT: K9's checkpoints in place of the score
// (linear gaps, pair scoring).  WARP: the calling warp runs the body alone
// (see the header; l all null, i0 = 0)
template <int K, bool AFFINE, bool MATRIX, bool LOCAL, bool CAPTURE, bool LOCATE,
          bool CKPT, bool EDGE = false, bool WARP = false>
__device__ __forceinline__ void strip(const Params& p, const CaptureArgs& c,
                                      const CkptArgs& ck, const int32_t* mat, int i0,
                                      const Link& l, int32_t& acc, int32_t& best_v,
                                      int& best_i, int& best_j, const Edge& edge = Edge{}) {
  __shared__ int32_t hand_h[2][kWarps];
  __shared__ int32_t hand_f[2][kWarps];
  const int r = WARP ? threadIdx.x & 31 : threadIdx.x;
  const int T = WARP ? 32 : blockDim.x;
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
  // warp 0 brings the input row into in_buf a chunk of kChunk columns at
  // a time, the next chunk's loads in flight in next_h/next_f for kChunk
  // steps, so no step waits on L2 (each lane checks the flag with its own
  // acquire load, keeping the last value seen)
  __shared__ int32_t in_buf[2][kChunk];
  const bool fetch = !WARP && l.in_h != nullptr && warp == 0;
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
  int free_to = 0;  // the last thread: columns of its slot known read
  int ch = 0;       // the text code of this step's column
  // WARP: the warp holds the text 32 codes a chunk, lane l code 32c + l of
  // chunk c: the chunk of lane 0's column and the one before it as the two
  // low bytes of cw, the next chunk's loads in flight in cn for 32 steps,
  // so no step waits on L2; a lane takes its column's code by one shuffle
  int cw = 0, cn = 0;
  if (WARP) cn = lane < m ? p.text[lane] : 0;
  const int steps = m + t_live;
  for (int t = 0; t < steps; ++t) {
    // thread r-1's bottom row at column t - r, computed at step t - 1
    int32_t in_h = __shfl_up_sync(0xffffffffu, out_h, 1);
    int32_t in_f = AFFINE ? __shfl_up_sync(0xffffffffu, out_f, 1) : 0;
    const int j = t - r;
    const bool active = j >= 0 && j <= m && r < t_live;
    if (WARP) {
      if (((t - 1) & 31) == 0) {  // t = 32c + 1: chunk c is lane 0's from here
        cw = ((cw >> 8) & 0xff) | ((cn & 0xff) << 8);
        cn = t + 31 + lane < m ? p.text[t + 31 + lane] : 0;  // chunk c + 1
      }
      const int x = j - 1;  // this lane's column's code
      const int v = __shfl_sync(0xffffffffu, cw, x & 31);
      ch = static_cast<int8_t>(x >= ((t - 1) & ~31) ? v >> 8 : v);
    }
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
      if (WARP || l.in_h == nullptr) {
        in_h = top_h<AFFINE, LOCAL, CAPTURE>(p, j);
        if (AFFINE) in_f = CAPTURE ? in_h + c.tb : kNeg;
        if (want_col && j == m) c.col[0] = in_h;
      } else {
        in_h = in_buf[0][j % kChunk];
        if (AFFINE) in_f = in_buf[1][j % kChunk];
        if (EDGE && want_col && i0 == 0 && j == m) c.col[0] = in_h;
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
        if (EDGE) {
          h[q] = q < nlive ? edge.left[i] : 0;
        } else {
          h[q] = (LOCAL || zc) ? 0 : (AFFINE ? open0 + i * p.ext : i * p.gap);
        }
        e[q] = kNeg;
      }
      out_h = h[K - 1];
      out_f = kNeg;
      fn = (LOCAL || zc) ? 0 : open0 + n * p.ext;  // F(n, 0) := H(n, 0)
    } else if (active) {
      const int c = ch;
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
      if (!WARP && l.out_h != nullptr) {
        if (l.out_free != nullptr && free_to <= j) {
          do {
            free_to = load_acquire(l.out_free);
          } while (free_to <= j);
        }
        __stcg(l.out_h + j, out_h);
        if (AFFINE) __stcg(l.out_f + j, out_f);
        if ((j + 1) % kPublish == 0 || j == m) store_release(l.out_ready, j + 1);
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
    // the next step's text code (column j + 1), a step ahead
    if (!WARP && j + 1 >= 1 && j + 1 <= m) ch = p.text[j];
    diag_top = in_h;
    if (!WARP) {
      if (lane == 31) {
        hand_h[t & 1][warp] = out_h;
        if (AFFINE) hand_f[t & 1][warp] = out_f;
      }
      __syncthreads();
    }
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

// K6's tile: columns a step at K rows a thread (band.py's TILE_W), the
// fastest of 4, 8 and 16 at each K on the H100; each divides kChunk, and
// the fetch wants two steps or more a chunk
__host__ __device__ constexpr int tile_w(int K) { return K <= 4 ? 4 : 8; }

// H(i, 0) of the table's left edge, closed form: 0 (row 0, local, zc),
// open + i*ext (affine), i*gap
template <bool AFFINE, bool LOCAL>
__device__ __forceinline__ int32_t left_h(const Params& p, int i) {
  if (LOCAL || i == 0 || (p.flags & kZeroCol)) return 0;
  return AFFINE ? p.open + i * p.ext : i * p.gap;
}

// The text codes of one tile's W columns b*W+1 .. b*W+W, four to a word
// (0 past m): aligned words where the tile is whole, bytes at the end
template <int W>
__device__ __forceinline__ void tile_codes(const int8_t* text, int m, int b, bool aligned,
                                           uint32_t (&cw)[W / 4]) {
  const int j0 = b * W;
  if (aligned && j0 + W <= m) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(text + j0);
#pragma unroll
    for (int x = 0; x < W / 4; ++x) cw[x] = src[x];
    return;
  }
#pragma unroll
  for (int x = 0; x < W / 4; ++x) {
    uint32_t v = 0;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int j = j0 + 4 * x + y;
      if (j < m) v |= static_cast<uint32_t>(static_cast<uint8_t>(text[j])) << (8 * y);
    }
    cw[x] = v;
  }
}

// One K x W tile of K6's score: the thread's rows top+1 .. top+K at columns
// j0+1 .. j0+W, h (and e) their left column in and their last column out, hw
// (and fw) the top row in (row top) and the bottom row out, diag H(top,
// j0).  Under linear gaps h, hw and diag hold H + gap, which is at once the
// next row's up + gap and the next column's left + gap, so a cell is one
// three-way max; a pair's or the matrix's score then comes less the gap.
// MASK: a tile with rows past n or columns past m (live only those with
// q < nlive and a column at most m), or one whose cells the ends-free or
// global score reads; without it every cell is live and only the local
// max reads them, into vmax by row
template <int K, int W, bool AFFINE, bool MATRIX, bool LOCAL, bool MASK>
__device__ __forceinline__ void tile(const Params& p, const int32_t* mat, const int (&rc)[K],
                                     const uint32_t (&cw)[W / 4], int j0, int32_t diag,
                                     int32_t (&h)[K], int32_t (&e)[K], int32_t (&hw)[W],
                                     int32_t (&fw)[W], int32_t (&vmax)[K], int32_t& acc,
                                     int nlive, bool owns_n, int qn) {
  const int m = p.m;
  const bool er = p.flags & kEndRow, ec = p.flags & kEndCol;
  const int g0 = AFFINE ? 0 : p.gap;  // what h, hw and diag hold beyond H
  const int32_t sm = p.match - g0, smm = p.mismatch - g0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = j0 + w + 1;
    const int c = static_cast<int8_t>(cw[w / 4] >> (8 * (w % 4)));
    const int cK = MATRIX ? c * p.K : 0;
    int32_t up = hw[w], upf = fw[w];
    int32_t d = diag;
    diag = up;  // the next column's diagonal at the top row
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int32_t s = MATRIX ? mat[cK + rc[q]] : (c == rc[q] ? sm : smm);
      int32_t hn;
      if (AFFINE) {
        e[q] = __viaddmax_s32(h[q], p.open, e[q]) + p.ext;
        upf = __viaddmax_s32(up, p.open, upf) + p.ext;
        hn = LOCAL ? __vimax3_s32_relu(d + s, e[q], upf) : __vimax3_s32(d + s, e[q], upf);
      } else {
        hn = LOCAL ? __vimax3_s32_relu(up, h[q], d + s) : __vimax3_s32(up, h[q], d + s);
      }
      if (LOCAL && (!MASK || (q < nlive && j <= m))) vmax[q] = max(vmax[q], hn);
      d = h[q];
      h[q] = hn + g0;
      up = h[q];
    }
    hw[w] = up;
    fw[w] = upf;
    if (MASK && !LOCAL && j <= m) {
      if (ec && j == m) {
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (q < nlive) acc = max(acc, h[q] - g0);
        }
      }
      if (owns_n && (er || j == m)) acc = max(acc, pick(h, qn) - g0);
    }
  }
}

// K6's strip, tiled: the score contract of strip (no captures, locating,
// checkpoints or edges) with a K x W tile a thread a step (see the header):
// at step t thread r computes tile t - r, columns (t-r)*W + 1 .. (t-r)*W + W
template <int K, bool AFFINE, bool MATRIX, bool LOCAL>
__device__ __forceinline__ void tile_strip(const Params& p, const int32_t* mat, int i0,
                                           const Link& l, int32_t& acc) {
  constexpr int W = tile_w(K);
  constexpr int P = kChunk / W;  // steps a chunk of the input row serves
  static_assert(W % 4 == 0 && kChunk % W == 0 && P >= 2, "a tile's width");
  __shared__ int32_t hand_h[2][kWarps][W];
  __shared__ int32_t hand_f[2][kWarps][W];
  __shared__ int32_t in_buf[2][2][kChunk];  // [chunk parity][H, F][column]
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int m = p.m;
  const int n = p.n;
  const int top = i0 + r * K;  // this thread's rows are top+1 .. top+K
  const int nlive = max(0, min(K, n - top));
  // every row live: from n and top, not from nlive (ptxas turned nlive == K
  // into the predicate of the DPX min that makes nlive, and the thread that
  // owns row n took the unmasked tile)
  const bool full = top + K <= n;
  const int t_live = (min(K * T, n - i0) + K - 1) / K;  // threads with a live row
  const bool owns_n = top < n && n <= top + K;
  const int qn = n - top - 1;
  const bool er = p.flags & kEndRow;
  const int tiles = (m + W - 1) / W;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.text) & 3) == 0;
  const int g0 = AFFINE ? 0 : p.gap;  // what the tile's H values hold beyond H (see tile)
  int rc[K];
  int32_t h[K], e[K], vmax[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    rc[q] = q < nlive ? p.query[top + q] : 0;
    h[q] = left_h<AFFINE, LOCAL>(p, top + q + 1) + g0;  // column 0
    e[q] = kNeg;
    vmax[q] = 0;
  }
  int32_t hw[W], fw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    hw[w] = kNeg;
    fw[w] = kNeg;
  }
  int32_t diag = left_h<AFFINE, LOCAL>(p, top) + g0;  // H(top, 0)
  uint32_t cw[W / 4];
  if (r == 0) tile_codes<W>(p.text, m, 0, aligned, cw);
  // warp 0 brings the input row into in_buf a chunk of kChunk columns at a
  // time (chunk c: columns c*kChunk + 1 .. c*kChunk + kChunk), the next
  // chunk's loads in flight in next_h/next_f over the P steps of this one
  const bool fetch = l.in_h != nullptr && warp == 0;
  int seen = 0;
  int32_t next_h = 0, next_f = 0;
  if (fetch) {
    while (seen < min(kChunk + 1, m + 1)) seen = load_acquire(l.in_ready);
    if (lane < m) {
      in_buf[0][0][lane] = __ldcg(l.in_h + lane + 1);
      if (AFFINE) in_buf[0][1][lane] = __ldcg(l.in_f + lane + 1);
    }
    if (kChunk < m) {
      while (seen < min(2 * kChunk + 1, m + 1)) seen = load_acquire(l.in_ready);
      if (kChunk + lane < m) {
        next_h = __ldcg(l.in_h + kChunk + lane + 1);
        if (AFFINE) next_f = __ldcg(l.in_f + kChunk + lane + 1);
      }
    }
  }
  __syncthreads();  // chunk 0 is in
  int free_to = 0;  // the last thread: columns of its slot known read
  const int steps = tiles + t_live - 1;
  for (int t = 0; t < steps; ++t) {
    // thread r-1's bottom row of tile t - r, computed at step t - 1
#pragma unroll
    for (int w = 0; w < W; ++w) {
      hw[w] = __shfl_up_sync(0xffffffffu, hw[w], 1);
      if (AFFINE) fw[w] = __shfl_up_sync(0xffffffffu, fw[w], 1);
    }
    const int b = t - r;
    const bool active = b >= 0 && b < tiles && r < t_live;
    if (fetch && t % P == P - 1 && (t / P + 1) * kChunk < m) {
      // the last step of chunk c: chunk c + 1 lands in in_buf (thread 0
      // reads it from the next step on, after this step's barrier), chunk
      // c + 2 starts loading
      const int c1 = t / P + 1;
      in_buf[c1 & 1][0][lane] = next_h;
      if (AFFINE) in_buf[c1 & 1][1][lane] = next_f;
      if ((c1 + 1) * kChunk < m) {
        while (seen < min((c1 + 2) * kChunk + 1, m + 1)) seen = load_acquire(l.in_ready);
        const int j = (c1 + 1) * kChunk + lane + 1;
        if (j <= m) {
          next_h = __ldcg(l.in_h + j);
          if (AFFINE) next_f = __ldcg(l.in_f + j);
        }
      }
    }
    if (lane == 0 && warp > 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        hw[w] = hand_h[(t - 1) & 1][warp - 1][w];
        if (AFFINE) fw[w] = hand_f[(t - 1) & 1][warp - 1][w];
      }
    }
    if (r == 0 && active) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (l.in_h == nullptr) {
          hw[w] = top_h<AFFINE, LOCAL, false>(p, b * W + w + 1) + g0;
          fw[w] = kNeg;
        } else {
          const int x = (b % P) * W + w;
          hw[w] = in_buf[(b / P) & 1][0][x] + g0;
          if (AFFINE) fw[w] = in_buf[(b / P) & 1][1][x];
        }
      }
    }
    if (active) {
      const int j0 = b * W;
      const int32_t d = diag;
      diag = hw[W - 1];  // H(top, j0 + W): the next tile's diagonal
      const bool whole = full && (LOCAL ? j0 + W <= m : j0 + W < m && !(owns_n && er));
      if (whole) {
        tile<K, W, AFFINE, MATRIX, LOCAL, false>(p, mat, rc, cw, j0, d, h, e, hw, fw, vmax, acc,
                                                 nlive, owns_n, qn);
      } else {
        tile<K, W, AFFINE, MATRIX, LOCAL, true>(p, mat, rc, cw, j0, d, h, e, hw, fw, vmax, acc,
                                                nlive, owns_n, qn);
      }
      if (r == T - 1 && l.out_h != nullptr) {  // the next strip's input row
        // the columns up to j0, stored a step ago, are published before
        // this tile's stores, so the release's fence finds them drained
        if (j0 > 0 && j0 % kPublish == 0) store_release(l.out_ready, j0 + 1);
        const int last = min(j0 + W, m);
        if (l.out_free != nullptr && free_to <= last) {
          do {
            free_to = load_acquire(l.out_free);
          } while (free_to <= last);
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (j0 + w < m) {
            __stcg(l.out_h + j0 + w + 1, hw[w] - g0);
            if (AFFINE) __stcg(l.out_f + j0 + w + 1, fw[w]);
          }
        }
        if (last == m) store_release(l.out_ready, m + 1);
      }
    }
    // the next tile's codes, a step ahead
    if (b + 1 >= 0 && b + 1 < tiles && r < t_live) tile_codes<W>(p.text, m, b + 1, aligned, cw);
    if (lane == 31) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        hand_h[t & 1][warp][w] = hw[w];
        if (AFFINE) hand_f[t & 1][warp][w] = fw[w];
      }
    }
    __syncthreads();
  }
  if (LOCAL) {
#pragma unroll
    for (int q = 0; q < K; ++q) acc = max(acc, vmax[q]);
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

// The pipelined schedule (see the header): the blocks take strips from a
// ticket and hand rows down through the ring
template <int K, bool AFFINE, bool MATRIX, bool LOCAL, bool CAPTURE, bool LOCATE,
          bool CKPT, bool EDGE = false, bool TILE = false>
__device__ __forceinline__ void fill_pipe(const Params& p, const CaptureArgs& c,
                                          const Pipe& q, const CkptArgs& ck,
                                          const Edge& edge = Edge{}) {
  __shared__ int32_t mat[kMaxCodes * kMaxCodes];
  __shared__ int32_t red[LOCATE ? 3 : 1][kWarps];
  __shared__ int ticket;
  __shared__ bool last_block;
  const int r = threadIdx.x;
  const int T = blockDim.x;
  const int m = p.m;
  if (MATRIX) {  // the tiled linear fill takes the matrix less the gap (see tile)
    const int less = TILE && !AFFINE ? p.gap : 0;
    for (int x = r; x < p.K * p.K; x += T) mat[x] = p.matrix[x] - less;
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
    } else if (EDGE) {
      l.in_h = edge.top;
      l.in_ready = &kEdgeReady;
    }
    if (s + 1 < q.strips) {
      int32_t* row = q.ring + static_cast<size_t>(s % q.depth) * stride;
      l.out_h = row;
      l.out_f = row + m + 1;
      l.out_ready = progress + s;
      if (s >= q.depth) l.out_free = progress + s - q.depth + 1;
    }
    if constexpr (TILE) {
      tile_strip<K, AFFINE, MATRIX, LOCAL>(p, mat, s * K * T, l, acc);
    } else {
      strip<K, AFFINE, MATRIX, LOCAL, CAPTURE, LOCATE, CKPT, EDGE>(
          p, c, ck, mat, s * K * T, l, acc, best_v, best_i, best_j, edge);
    }
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

// K6's port: the score, pipelined, a tile a thread a step.  One block an SM
// at the least lets ptxas keep a tile in registers: with the default bound
// it stopped at 80 and spilled (k = 8 local affine with a matrix), and the
// affine fills ran 3-9% slower on the H100
template <int K, bool AFFINE, bool MATRIX, bool LOCAL>
__global__ void __launch_bounds__(kPipeThreads, 1) band_fill_kernel(Params p, Pipe q) {
  fill_pipe<K, AFFINE, MATRIX, LOCAL, false, false, false, false, true>(p, CaptureArgs{}, q,
                                                                       CkptArgs{});
}

// K7's port: the captures, under affine gaps the last row of F, and, with
// LOCATE, the located cell, pipelined
template <int K, bool AFFINE, bool MATRIX, bool LOCAL, bool LOCATE>
__global__ void __launch_bounds__(kPipeThreads)
    band_capture_kernel(Params p, CaptureArgs c, Pipe q) {
  fill_pipe<K, AFFINE, MATRIX, LOCAL, true, LOCATE, false>(p, c, q, CkptArgs{});
}

// K7's sharded contract: the linear captures with the block's edges in
template <int K, bool MATRIX, bool LOCAL, bool LOCATE>
__global__ void __launch_bounds__(kPipeThreads)
    band_edge_kernel(Params p, CaptureArgs c, Edge e, Pipe q) {
  fill_pipe<K, false, MATRIX, LOCAL, true, LOCATE, false, true>(p, c, q, CkptArgs{}, e);
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
         threads > kPipeThreads || threads % 32 != 0;
}

// The pipeline's arguments: a geometry of at most kPipeThreads threads, k
// rows each, `blocks` blocks; the ring and the flags when S >= 2; the
// blocks' cells when locating.  Fills q, or returns false
bool pipe_args(int m, int n, int K, int k, int threads, int blocks, void* ring,
               int depth, void* sync, void* cells, bool locate, Pipe& q) {
  if (bad_geometry(m, n, K, threads) || k < 1 || k > 16 ||
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
