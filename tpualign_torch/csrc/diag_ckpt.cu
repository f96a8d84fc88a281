// Checkpointed fill for the diagonal-band traceback
// (ops/traceback_diag.py): pair scoring, linear gaps, global or local.
//
// Replaces the TPU kernel
// tpualign/ops/pallas_diag.py:_diag_ckpt_kernel_body (K9).  Contract, the
// same as ckpt_plain in tpualign_torch/ops/pallas_diag.py:
//
//   in:  s1    (m,)  int8 codes, across the columns
//        s2    (n,)  int8 codes, down the rows (either sequence may be the
//                    longer, nothing is swapped)
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
//   scratch: the strip pipeline's ring and flags (band_fill.cuh)
//
// The TPU kernel walks the anti-diagonals of the table in VMEM, one
// diagonal a step, and DMAs its (diagonal cK, cK-1) buffers to HBM before
// each group of K steps.  Its outputs are exact cell values, none of which
// depends on the order the cells are computed in, so here they come from
// band_fill.cuh's row strips (CKPT): s1 is the strips' text and s2 their
// query, the strips run side by side over many thread blocks, each strip's
// bottom row handed down through the ring (fill_pipe).  The thread that
// owns row i writes every slot of row i: as it computes cell (i, j) with
// i + j = cK or cK - 1 it stores the cell (column 0 included, which it
// computes in closed form).  A thread keeps which of its rows is the first
// on a diagonal cK (and so cK - 1) as a countdown, a row higher each
// column: the step does no division, and stores only on the few steps in
// every K where one of its k rows hits, at most two rows a stride (every =
// 8 and k = 16).  At its strip's end it writes NEG to the row's dead
// slots and, local, v and dbest from the running max it kept in registers
// (a strict `>`, the TPU kernel's `improved = v > v[k]`).  Strip 0's thread
// 0 writes row 0, the closed-form top edge.  Checkpoint stores never go
// through the ring: a checkpoint diagonal crosses every strip, and each
// strip stores its own cells of it.
//
// What bounds it: the pipeline's step, as in K6 (band_fill.cuh's note):
// about m + T + (S-1)(T + 2 kChunk) steps of k rows a thread and a block
// barrier each, at a fixed cost a step that the cells do not set.  The
// checkpoints add 2 (n+1) scattered 4-byte stores every K diagonals (252
// MB at the 64gb shape, K = 1,024): on an H100 they cost about 11 of the
// fill's 75 ms there, which takes 64 ms at K = 2^20, where almost none
// are stored (tools/bench_diag_ckpt.py --strides); staging a warp's stores
// in shared memory would be the next step.  Where the earlier port of
// this kernel (K8's wavefront on one SM, 16.7 us a diagonal) walked n + m
// diagonals behind one block, the strips keep every SM busy.

#include "band_fill.cuh"

namespace {

// K9's port: the pipelined strips under the checkpoint contract
template <int K, bool LOCAL>
__global__ void __launch_bounds__(kPipeThreads)
    diag_ckpt_kernel(Params p, CkptArgs ck, Pipe q) {
  fill_pipe<K, false, false, LOCAL, false, false, true>(p, CaptureArgs{}, q, ck);
}

template <bool LOCAL>
int launch_ckpt(int k, int threads, int blocks, cudaStream_t s, const Params& p,
                const CkptArgs& ck, const Pipe& q) {
  switch (k) {
#define CKPT_CASE(K)                                                          \
  case K:                                                                     \
    diag_ckpt_kernel<K, LOCAL><<<blocks, threads, 0, s>>>(p, ck, q);          \
    break;
    CKPT_CASE(1)
    CKPT_CASE(2)
    CKPT_CASE(4)
    CKPT_CASE(8)
    CKPT_CASE(16)
#undef CKPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the checkpointed fill on `stream`: stride K (a multiple of 8),
// `blocks` blocks of `threads` threads (a multiple of 32, at most 256) of
// k rows each (k in {1, 2, 4, 8, 16}), S = ceil(n / (k*threads)) strips
// over the rows (s2).  `ring` is (depth, 1, m+1) int32 scratch, depth >= 2,
// when S >= 2 (else unused); `sync` is (S + 2,) int32, zeroed.  cka and
// ckb are (ceil((n+m)/K), n+1) int32, v and dbest (n+1,) int32, written
// under local scoring only (null otherwise).  Returns the cudaError_t of
// the launch; the fill itself runs asynchronously.
extern "C" int diag_ckpt_fill(const void* s1, int m, const void* s2, int n,
                              int match, int mismatch, int gap, int local,
                              int K, int k, int threads, int blocks, void* ring,
                              int depth, void* sync, void* cka, void* ckb,
                              void* v, void* dbest, void* stream) {
  Pipe q;
  if (!pipe_args(m, n, 0, k, threads, blocks, ring, depth, sync, nullptr, false, q) ||
      K < 8 || K % 8 != 0 || cka == nullptr || ckb == nullptr ||
      (local && (v == nullptr || dbest == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const int8_t*>(s1),
                 m,
                 static_cast<const int8_t*>(s2),
                 n,
                 nullptr,
                 0,
                 match,
                 mismatch,
                 gap,
                 0,
                 0,
                 local ? (kLocal | kZeroRow | kZeroCol) : 0,
                 nullptr,
                 nullptr,
                 nullptr};
  const int groups = static_cast<int>((static_cast<long long>(n) + m + K - 1) / K);
  const CkptArgs ck{static_cast<int32_t*>(cka), static_cast<int32_t*>(ckb),
                    static_cast<int32_t*>(v), static_cast<int32_t*>(dbest), K, groups};
  auto s = static_cast<cudaStream_t>(stream);
  return local ? launch_ckpt<true>(k, threads, blocks, s, p, ck, q)
               : launch_ckpt<false>(k, threads, blocks, s, p, ck, q);
}
