// Bit-parallel Needleman-Wunsch fill of a batch of pairs under the scoring
// family (1, 0, -g), g = 1..7, the whole batch in one launch.
//
// Replaces the TPU kernel tpualign/ops/bitpal.py:_batch_kernel_body (K5),
// which fills same-bucket pairs interleaved in one row block.  Contract,
// word for word the same as batch_fill_plain in tpualign_torch/ops/bitpal.py:
//
//   in:  texts   (P, m_cap)       int8, pair p's text in texts[p][0..mt[p])
//                                 (codes 0..4; other codes match nothing)
//        mts     (P,)             int64, text lengths in 1..m_cap
//        eq      (P, 5, nw)       uint64, bit b of eq[p][c][w] set iff
//                                 query_p[64w+b] == c; rows past the
//                                 pair's query match nothing
//        g                        the reduced gap weight, 1..7
//   out: planes  (P, B, nw)       uint64, pair p's final column v(i, mt[p])
//                                 as B bit planes of enc = v + g, B = bit
//                                 length of 2g + 1, over all nw words
//
// The rows past a pair's query match nothing and lie below its last row;
// deltas flow down only, so they never reach the pair's rows, and every
// pair of the batch shares nw.  Their planes are still defined (the same
// wavefront runs over them), so kernel and plain version compare word for
// word there too.  Word w computes column d - w at step d, as in
// bitpal_gfill.cu, and a pair's words keep their planes outside its
// columns 1..mt[p] (batch_fill_plain's live mask).
//
// Schedule: one warp a block, one word a lane, two bodies by nw.
//   Short pairs (nw <= 16, e.g. 150-base reads, nw = 3): a pair takes a
//   segment of W lanes, W the next power of two >= nw, and a warp holds
//   32 / W pairs.  Lane w of a segment takes word w-1's h_out of the last
//   step by __shfl_up_sync(mask, x, 1, W), which stays inside the segment;
//   lane 0 of each segment drops what it receives and takes the top
//   boundary h = -g (enc 0).  Each lane loads its pair's code of the next
//   step's column a step ahead; there is no ring.  A warp runs to the end
//   of its longest pair (mt + nw - 1 steps); a pair whose text is shorter
//   keeps its planes from there on.  The blocks take the warps in turn
//   (grid-stride), no barrier anywhere.
//   Long pairs (nw > 16, e.g. 23,701-base queries, nw = 371, 12 bands):
//   bitpal_gfill.cu's band body (bitpal_gband.cuh) as it is, a Fill a pair:
//   bands of 32 words, one warp a band, each band's bottom h_out stream
//   handed down through the pair's own ring of D rows of m_cap bytes with
//   progress flags that count the pair's own columns.  The blocks take
//   (pair, band) tickets in pair-major order, so a band only ever waits on
//   the ticket before its own, which a running block holds; a reused ring
//   row's writer waits for its reader, so any D >= 2 is correct.  A pair of
//   17..32 words is one band and needs no ring.
// The band body is shared, not copied: the batch's long pairs are K1/K2's
// fill a pair at a time, and sharing it leaves bitpal_gfill_kernel's SASS
// as it is (tools/sass_compare.py).
//
// What the TPU layout does and this one does not: the TPU interleaves the
// pairs in one row block so that one step advances them all, with one
// shared sublane roll, a per-pair row-0 patch, a column-major text packed
// 8 pairs to a word and pend rings.  Here segments of a warp and bands
// over many blocks spread the pairs over the card's 132 SMs.
//
// What bounds it: as in bitpal_gfill.cu, a step is a chain of one word
// step and a shuffle in one warp, so its time is its instructions'
// latency.  Short pairs: about max(mt) + nw steps a warp, 8 pairs a warp
// at nw = 3.  Long pairs: each pair a pipelined wavefront of about mt + nw
// + bands * 2 kChunk steps, the pairs side by side while blocks last.

#include "bitpal_gband.cuh"

namespace {

constexpr int kSegmentMax = 16;  // the widest segment; wider pairs run bands

struct Batch {
  const int8_t* texts;
  int64_t m_cap;
  const int64_t* mts;
  const u64* eq;
  int pairs;
  int nw;
  int vmax;
  u64* planes;
  uint8_t* ring;  // (pairs, depth, m_cap): each long pair's ring
  int* sync;      // zeroed (1 + pairs * bands,): the ticket, then each band's progress
  int bands;      // bands a pair
  int depth;      // D, at least 2 when bands >= 2
};

// pair text column col (1-based) as a code, kAlphabet outside 1..mt or 0..4
__device__ __forceinline__ unsigned pair_code(const int8_t* text, int64_t mt, int64_t col) {
  const int c = (col >= 1 && col <= mt) ? text[col - 1] : kAlphabet;
  return (c >= 0 && c < kAlphabet) ? c : kAlphabet;
}

// One word step from h_top enc h; the planes move only where `live`.
// Returns the word's h_out enc
template <int B>
__device__ __forceinline__ unsigned word_step(u64 E, u64 (&V)[B], const u64 (&vm)[B],
                                              unsigned h, bool live) {
  u64 u[B], U[B], Vn[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    u[b] = (h >> b) & 1;
    Vn[b] = V[b];
  }
  if constexpr (B == 2) {
    plane_step(E, Vn[0], Vn[1], u[0], u[1], U[0], U[1]);
  } else {
    g_plane_step<B>(E, Vn, u, vm, U);
  }
  unsigned hn = 0;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    V[b] = live ? Vn[b] : V[b];
    hn |= static_cast<unsigned>(u[b]) << b;
  }
  return hn;
}

// Warp `warp`'s pairs, 32 / W of them, a segment of W lanes each
template <int B, int W>
__device__ __forceinline__ void segments(const Batch& a, int64_t warp) {
  const int lane = threadIdx.x & 31;
  const int word = lane & (W - 1);
  const int64_t p = warp * (32 / W) + lane / W;
  const bool pair = p < a.pairs;
  const bool own = pair && word < a.nw;
  const int64_t mt = pair ? a.mts[p] : 0;
  const int8_t* text = a.texts + (pair ? p : 0) * a.m_cap;
  u64 e[kAlphabet], V[B], vm[B];
#pragma unroll
  for (int c = 0; c < kAlphabet; ++c) {
    e[c] = own ? a.eq[(p * kAlphabet + c) * a.nw + word] : 0;
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    V[b] = 0;  // column 0: v = -g, enc 0
    vm[b] = ((a.vmax >> b) & 1) ? ~0ull : 0ull;
  }
  // the warp runs to its longest pair: word nw - 1 ends at step mt + nw - 1
  int64_t last = pair ? mt + a.nw - 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t other = __shfl_down_sync(0xffffffffu, last, off);
    last = other > last ? other : last;
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  unsigned ci = pair_code(text, mt, 1 - word);  // the code of this step's column
  unsigned hp = 0;                              // the word's h_out enc of the last step
  for (int64_t d = 1; d <= last; ++d) {
    const int64_t j = d - word;
    const unsigned nx = pair_code(text, mt, j + 1);  // the next step's, a step ahead
    const unsigned h = __shfl_up_sync(0xffffffffu, hp, 1, W);
    // lane 0 of a segment: the top boundary h = -g, enc 0
    hp = word_step<B>(match(e, ci), V, vm, word ? h : 0u, j >= 1 && j <= mt);
    ci = nx;
  }
  if (own) {
#pragma unroll
    for (int b = 0; b < B; ++b) a.planes[(p * B + b) * a.nw + word] = V[b];
  }
}

// short pairs: the blocks take the warps in turn
template <int B, int W>
__global__ void __launch_bounds__(32) bitpal_batch_kernel(const Batch a) {
  const int64_t warps = (static_cast<int64_t>(a.pairs) * W + 31) / 32;
  for (int64_t w = blockIdx.x; w < warps; w += gridDim.x) segments<B, W>(a, w);
}

// long pairs: the blocks take (pair, band) tickets in pair-major order, each
// pair a Fill of bitpal_gband.cuh over its own text, planes, ring and flags
template <int B>
__global__ void __launch_bounds__(32) bitpal_batch_band_kernel(const Batch a) {
  take_bands(a.sync, a.pairs * a.bands, [&](int x) {
    const int64_t p = x / a.bands;
    const Fill f{a.texts + p * a.m_cap,
                 a.eq + p * kAlphabet * a.nw,
                 a.mts[p],
                 a.nw,
                 a.vmax,
                 nullptr,
                 0,
                 nullptr,
                 a.planes + p * B * a.nw,
                 a.ring + p * a.depth * a.m_cap,
                 a.sync + p * a.bands,  // pair p's progress[s] is sync[1 + p * bands + s]
                 a.bands,
                 a.depth};
    band<B, false>(f, static_cast<int>(x - p * a.bands));
  });
}

template <int B>
int launch_b(int blocks, cudaStream_t s, const Batch& a) {
  if (a.nw > kSegmentMax) {
    bitpal_batch_band_kernel<B><<<blocks, 32, 0, s>>>(a);
  } else if (a.nw > 8) {
    bitpal_batch_kernel<B, 16><<<blocks, 32, 0, s>>>(a);
  } else if (a.nw > 4) {
    bitpal_batch_kernel<B, 8><<<blocks, 32, 0, s>>>(a);
  } else if (a.nw > 2) {
    bitpal_batch_kernel<B, 4><<<blocks, 32, 0, s>>>(a);
  } else if (a.nw > 1) {
    bitpal_batch_kernel<B, 2><<<blocks, 32, 0, s>>>(a);
  } else {
    bitpal_batch_kernel<B, 1><<<blocks, 32, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5's contract: launches the batch fill on `stream` over `blocks` blocks
// of one warp and writes the B final planes of pair p to planes[p] (B,
// nw).  nw <= 16: segments of a warp, `ring` and `sync` unused.  nw > 16:
// bands = ceil(nw / 32) bands a pair, `sync` (1 + pairs * bands) int32,
// zeroed, and with bands >= 2 `ring` (pairs, depth, m_cap) bytes, depth >=
// 2.  Returns the cudaError_t of the launch; the fill itself runs
// asynchronously.
extern "C" int bitpal_batch_fill(const void* texts, int64_t m_cap, const void* mts,
                                 const void* eq, int pairs, int nw, int g, int blocks,
                                 void* ring, int depth, void* sync, void* planes,
                                 void* stream) {
  // the progress flags are int32 column counts, the tickets int32
  if (g < 1 || g > kMaxG || pairs < 1 || m_cap < 1 || m_cap > 0x7fffffff || nw < 1 ||
      blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bands = nw > kSegmentMax ? (nw + 31) / 32 : 1;
  if (nw > kSegmentMax &&
      (sync == nullptr ||
       static_cast<int64_t>(pairs) * bands + blocks > 0x7fffffff ||
       (bands > 1 && (ring == nullptr || depth < 2)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Batch a{static_cast<const int8_t*>(texts), m_cap,
                static_cast<const int64_t*>(mts), static_cast<const u64*>(eq),
                pairs, nw, 2 * g + 1, static_cast<u64*>(planes),
                static_cast<uint8_t*>(ring), static_cast<int*>(sync), bands, depth};
  auto s = static_cast<cudaStream_t>(stream);
  // B = bit length of vmax = 2g + 1
  if (g == 1) return launch_b<2>(blocks, s, a);
  if (g <= 3) return launch_b<3>(blocks, s, a);
  return launch_b<4>(blocks, s, a);
}
