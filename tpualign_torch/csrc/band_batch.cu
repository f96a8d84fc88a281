// Entry point band_batch_fill: the strip score of band_fill.cuh (K6's
// contract) over a batch of pairs, the whole batch in one launch.
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
//                         H(n[p], m[p]).  The caller fills it with the max's
//                         identity (0 local, kNeg otherwise)
//
// Two schedules in one launch, the pairs split by the host's plan
// (ops/band_batch.py:batch_plan), which also orders them: `order` lists the
// L long pairs, longest first, then the short ones in the batch's order.
//
// Short pairs (a query of at most 32*KS rows): a warp a pair, the strip
// body of band_fill.cuh under WARP: lane r owns rows r*KS+1 .. r*KS+KS, the
// row above comes by __shfl_up_sync, the top row in closed form (top_h),
// no shared memory and no barrier a step.  A warp takes the next short
// pair from a ticket of its own (lane 0's atomicAdd, broadcast by a
// shuffle) and reduces the pair's result by shuffles into out[p].  The
// block's one barrier is the one behind the matrix's load into shared
// memory.
//
// Long pairs: the pipelined schedule of band_fill.cuh, every long pair's
// strips of kLongK*T rows numbered into one ticket, pair after pair: long
// pair i's strips are tickets first[i] .. first[i+1]-1.  A block takes a
// ticket, finds its pair by binary search over `first`, and runs the strip
// between the pair's own ring (depth[i] rows of m+1 int32 at ring_at[i], H
// then F under affine gaps) and its own progress flags; a block only ever
// waits on a lower ticket, which a running block holds, so no grid size
// deadlocks, and a reused slot's writer waits for its reader, so any depth
// >= 2 is correct.  The strip's score maxes into out[p] by atomicMax.
// The blocks take the strips first; a block that finds none left turns
// its warps to the short pairs.
//
// What the TPU layout does and this one does not: its pairs run one after
// another through one strip kernel in a scan, bottom-aligned in the strip
// with a first live slot, the text packed 8 codes a word and the boundary
// row in SMEM under a length cap; it refuses affine gaps, masked local
// scoring and pairs past one strip.  Here the pairs spread over the card's
// 132 SMs, a warp a short pair and a block a long pair's strip, and each
// runs the fill that band_fill runs, so it takes all of them.
//
// What bounds it: short pairs, the instructions of their cells (about 8
// integer instructions a cell, KS cells a lane a step, m + n/KS steps a
// pair, no barrier) over the card's warp schedulers, or one warp's step
// latency when few pairs are left; long pairs, as band_fill: a pair's
// pipeline runs about m + T + (S-1)(T + 2 kChunk) steps, each a block
// barrier and kLongK cells a thread, so the longest pair sets the time
// when the strips fit the blocks.

#include "band_fill.cuh"

namespace {

constexpr int kLongK = 8;  // a long pair's rows a thread (band.pipeline_geometry's)

struct BatchArgs {
  const int64_t* toff;
  const int64_t* qoff;
  const int32_t* m;
  const int32_t* n;
  const int64_t* order;    // (P,) the pairs: the L long ones, then the short ones
  const int64_t* first;    // (L+1,) long pair i's first ticket; first[L] = strips
  const int64_t* ring_at;  // (L,) long pair i's ring: its first int32 in ring
  const int64_t* depth;    // (L,) its rows, at least 2 when it has 2 strips or more
  int32_t* ring;
  int* sync;  // zeroed (2 + strips,): the strips' ticket, the short pairs', progress[x]
  int pairs;
  int longs;
  int strips;
};

// pair pr's table in p
__device__ __forceinline__ void pair_params(Params& p, const BatchArgs& a, int64_t pr) {
  p.text += a.toff[pr];
  p.m = a.m[pr];
  p.query += a.qoff[pr];
  p.n = a.n[pr];
  p.out += pr;
}

// Strip s of a long pair's `strips`: its rows in and out through the pair's
// ring of `depth` rows of `stride` int32 and its progress flags, as
// fill_pipe links a strip (which keeps its own copy inline: through this
// function K7's affine capture fills ran 7% slower on the H100, K6's
// affine SW 13% faster, so the single-table fills keep their code)
__device__ __forceinline__ Link ring_link(int32_t* ring, int* progress, int s, int strips,
                                          int depth, size_t stride, int m) {
  Link l{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (s > 0) {
    const int32_t* row = ring + static_cast<size_t>((s - 1) % depth) * stride;
    l.in_h = row;
    l.in_f = row + m + 1;
    l.in_ready = progress + s - 1;
  }
  if (s + 1 < strips) {
    int32_t* row = ring + static_cast<size_t>(s % depth) * stride;
    l.out_h = row;
    l.out_f = row + m + 1;
    l.out_ready = progress + s;
    if (s >= depth) l.out_free = progress + s - depth + 1;
  }
  return l;
}

// Ticket x of the long pairs' strips, run by the block
template <bool AFFINE, bool MATRIX, bool LOCAL>
__device__ __forceinline__ void long_strip(Params p, const BatchArgs& a, const int32_t* mat,
                                           int x, int32_t* red) {
  int lo = 0, hi = a.longs - 1;  // the long pair whose tickets hold x
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.first[mid] <= x) lo = mid; else hi = mid - 1;
  }
  pair_params(p, a, a.order[lo]);
  const int s = x - static_cast<int>(a.first[lo]);
  const int strips = static_cast<int>(a.first[lo + 1] - a.first[lo]);
  const size_t stride = static_cast<size_t>(AFFINE ? 2 : 1) * (p.m + 1);
  const Link l = ring_link(a.ring + a.ring_at[lo], a.sync + 2 + a.first[lo], s, strips,
                           static_cast<int>(a.depth[lo]), stride, p.m);
  int32_t acc = LOCAL ? 0 : kNeg;
  int32_t best_v = kNeg;
  int best_i = kNoRow, best_j = 0;
  strip<kLongK, AFFINE, MATRIX, LOCAL, false, false, false>(
      p, CaptureArgs{}, CkptArgs{}, mat, s * kLongK * static_cast<int>(blockDim.x), l, acc,
      best_v, best_i, best_j);
  acc = block_max(acc, red);
  if (threadIdx.x == 0) atomicMax(p.out, acc);
}

// Short pair `slot` of the order, run by the calling warp
template <int K, bool AFFINE, bool MATRIX, bool LOCAL>
__device__ __forceinline__ void short_pair(Params p, const BatchArgs& a, const int32_t* mat,
                                           int slot) {
  pair_params(p, a, a.order[slot]);
  const Link l{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  int32_t acc = LOCAL ? 0 : kNeg;
  int32_t best_v = kNeg;
  int best_i = kNoRow, best_j = 0;
  strip<K, AFFINE, MATRIX, LOCAL, false, false, false, false, true>(
      p, CaptureArgs{}, CkptArgs{}, mat, 0, l, acc, best_v, best_i, best_j);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = max(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if ((threadIdx.x & 31) == 0) *p.out = acc;
}

template <int KS, bool AFFINE, bool MATRIX, bool LOCAL>
__global__ void __launch_bounds__(kPipeThreads) band_batch_kernel(Params p, BatchArgs a) {
  __shared__ int32_t mat[kMaxCodes * kMaxCodes];
  __shared__ int32_t red[kWarps];
  __shared__ int ticket;
  const int r = threadIdx.x;
  if (MATRIX) {
    for (int x = r; x < p.K * p.K; x += blockDim.x) mat[x] = p.matrix[x];
  }
  __syncthreads();
  while (a.strips > 0) {
    if (r == 0) ticket = atomicAdd(a.sync, 1);
    __syncthreads();
    const int x = ticket;
    __syncthreads();  // every thread has read the ticket before the next
    if (x >= a.strips) break;
    long_strip<AFFINE, MATRIX, LOCAL>(p, a, mat, x, red);
  }
  const int shorts = a.pairs - a.longs;
  for (;;) {
    int x = 0;
    if ((r & 31) == 0) x = atomicAdd(a.sync + 1, 1);
    x = __shfl_sync(0xffffffffu, x, 0);
    if (x >= shorts) break;
    short_pair<KS, AFFINE, MATRIX, LOCAL>(p, a, mat, a.longs + x);
  }
}

template <bool AFFINE, bool MATRIX, bool LOCAL>
int launch_batch(int k, int blocks, int threads, cudaStream_t s, const Params& p,
                 const BatchArgs& a) {
  switch (k) {
#define BATCH_CASE(K)                                                            \
  case K:                                                                        \
    if constexpr (AFFINE && LOCAL && K > 8) {                                    \
      return static_cast<int>(cudaErrorInvalidValue);                            \
    } else {                                                                     \
      band_batch_kernel<K, AFFINE, MATRIX, LOCAL><<<blocks, threads, 0, s>>>(p, a); \
    }                                                                            \
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
int launch_batch_mode(int k, int blocks, int threads, cudaStream_t s, const Params& p,
                      const BatchArgs& a) {
  const bool local = p.flags & kLocal;
  if (p.K > 0) {
    return local ? launch_batch<AFFINE, true, true>(k, blocks, threads, s, p, a)
                 : launch_batch<AFFINE, true, false>(k, blocks, threads, s, p, a);
  }
  return local ? launch_batch<AFFINE, false, true>(k, blocks, threads, s, p, a)
               : launch_batch<AFFINE, false, false>(k, blocks, threads, s, p, a);
}

}  // namespace

// Launches the batch fill on `stream`: `blocks` blocks of `threads` threads
// (a multiple of 32, at most 256); scoring and flags as band_fill.  The
// short pairs (queries of at most 32*k rows, k in {1, 2, 4, 8, 16}, at
// most 8 under local affine scoring) run a warp each at k rows a lane; the
// `longs` long pairs' `strips` strips of 8*threads rows run on the
// pipeline.  `sched` is int64: the order (pairs), then the long pairs'
// first tickets (longs + 1, the last `strips`), their rings' offsets in
// `ring` (longs, int32 elements) and their rings' rows (longs; at least 2
// for a pair of 2 strips or more, whose ring is rows x (1 or 2 (affine)) x
// (m+1) int32).  `sync` is (2 + strips,) int32, zeroed.  Pair p's result
// maxes into out[p], which the caller fills with 0 (local) or -2^30.
// Returns the cudaError_t of the launch; the fill itself runs
// asynchronously.
extern "C" int band_batch_fill(const void* texts, const void* queries, const void* toff,
                               const void* qoff, const void* m, const void* n, int pairs,
                               const void* matrix, int K, int match, int mismatch, int gap,
                               int gap_open, int gap_extend, int flags, int k, int threads,
                               int blocks, const void* sched, int longs, int strips,
                               void* ring, void* sync, void* out, void* stream) {
  // the tickets are int32: every block takes one past the strips, every
  // warp one past the short pairs
  const long long warps = static_cast<long long>(blocks) * (threads / 32);
  if (bad_geometry(1, 1, K, threads) || pairs < 1 || blocks < 1 || longs < 0 ||
      longs > pairs || strips < longs || (longs == 0) != (strips == 0) ||
      static_cast<long long>(strips) + blocks > 0x7fffffff ||
      pairs - longs + warps > 0x7fffffff || sched == nullptr || sync == nullptr ||
      out == nullptr) {
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
                 static_cast<int32_t*>(out)};
  const int64_t* order = static_cast<const int64_t*>(sched);
  const BatchArgs a{static_cast<const int64_t*>(toff),
                    static_cast<const int64_t*>(qoff),
                    static_cast<const int32_t*>(m),
                    static_cast<const int32_t*>(n),
                    order,
                    order + pairs,
                    order + pairs + longs + 1,
                    order + pairs + 2 * longs + 1,
                    static_cast<int32_t*>(ring),
                    static_cast<int*>(sync),
                    pairs,
                    longs,
                    strips};
  auto s = static_cast<cudaStream_t>(stream);
  return (flags & kAffine) ? launch_batch_mode<true>(k, blocks, threads, s, p, a)
                           : launch_batch_mode<false>(k, blocks, threads, s, p, a);
}
