// Bit-parallel Needleman-Wunsch fill for the scoring family (1, 0, -g),
// g = 1..7, with optional per-row captures of the horizontal deltas.
//
// Replaces three TPU kernels of tpualign/ops/bitpal.py:
//   _bitpal_kernel_body_lean (K1, and its twin _bitpal_kernel_body): the
//                             g = 1 fill, final column only;
//   _g_kernel_body      (K2): the (1, 0, -g) fill, final column only;
//   _chunk_kernel_body  (K4): the g-family fill that also streams the
//                             horizontal deltas of chosen DP rows, which the
//                             k-way Hirschberg split turns into rows of H.
// Contract, word for word the same as fill_g_plain in
// tpualign_torch/ops/bitpal.py:
//
//   in:  text      (mt,)      int8, codes 0..4 (other codes match nothing)
//        eq        (5, nw)    uint64, bit b of eq[c][w] set iff
//                             query[64w+b] == c
//        g                    the reduced gap weight, 1..7
//        cap_rows  (J,)       int32, ascending DP rows in 1..nq (K4 only)
//   out: planes    (B, nw)    uint64, the final column's vertical deltas
//                             v(i, mt) as B bit planes of enc = v + g,
//                             B = bit length of 2g + 1 (2, 3 or 4)
//        caps      (J, mt)    int8 (K4 only): caps[c][j-1] is the enc
//                             (h + g) of h = H(r, j) - H(r, j-1) for
//                             r = cap_rows[c]
//
// Deltas lie in [-g, 1+g], so enc lies in [0, 2g+1].  The promotion bit
// P = max(s, h_in - g, v_in - g) is binary exactly as at g = 1 (derivation
// in tpualign/ops/bitpal.py's module docstring and _g_plane_step); one
// carry-propagating add resolves it for 64 rows at once through runs of
// enc_v = 0, and both new deltas are then enc_out = 2g - enc_in + P,
// bit-sliced adds over the B planes.  At g = 1 (B = 2) the kernel runs the
// two-plane step of K1 (plane_step) instead.
//
// The TPU kernel K4 also carries its state in and out, takes word 0's h_top
// from an upstream stream and captures a tail row for the sharded pipeline;
// the state in and out is bitpal_rc.cu's bitpal_gfill_chunk, the rest waits
// for the port's sharded pipeline.  Its capture is per word bottom (row
// 31(w+1)) and staggered 2w steps; here any row can be captured, since
// every row's h_out is at hand in the U planes, and entry j-1 of a capture
// stream is column j.
//
// Query rows are packed 64 to a word (row 64w+b is bit b of word w).
// Schedule: a pipelined wavefront over many thread blocks of one warp.  The
// words are cut into bands of 32 words, one warp a band, one word a lane;
// lane t computes column d - t at the band's step d, so each word trails
// the word above it by one column (bitpal_rc.cu's stagger at one column a
// step), and takes the h_out of lane t-1's last step through one warp
// shuffle.  The band's bottom word hands its h_out enc (B <= 4 bits, one
// byte a column) down to the next band through a ring of D rows of mt
// bytes in global memory: band s writes row s mod D and publishes
// progress[s] = j with release semantics at least every kChunk columns and
// at column mt; the next band fetches that row a chunk of kChunk columns at
// a time, one byte a lane, the next chunk's loads in flight while this one
// is read (each lane waits with acquire until the chunk's columns are
// published, and loads through L2: L1 may hold a line from the row's last
// use).  Before it writes column j of a reused row, the bottom lane waits
// until progress[s-D+1] >= j, the band that read the row's old contents,
// so any D >= 2 is correct.  Blocks take bands in order from an atomic
// ticket, never from blockIdx, so a band only ever waits on a lower band,
// which a running block holds: no grid size deadlocks.  Band 0's word 0
// takes the top boundary h = -g, enc 0.
//
// A lane's 5 match words live in registers, and no step loads from global
// memory: lane t takes its code of the next step, lane t-1's of this one,
// in the hand-off's shuffle, and lane 0 takes the code of column d + 1 and
// the ring's byte of column d from lane (d-1) mod 32 of the chunk that the
// warp loaded a chunk ahead, a code and a byte a lane.  The steady part of
// a band, where every word's column lies in 1..mt, runs a chunk of 32
// steps at a time without a branch in a step (the shuffle's source at a
// constant phase, the bottom lane's store and the word's first capture
// predicated); the chunk's fetch, the backpressure wait and the publish run
// once a chunk.  The ramp, the drain and the steps outside whole chunks run
// a step at a time with their checks; columns outside 1..mt leave the
// planes as they are.  A capture is written by the lane that owns its
// row's word, one int8 store per live column.
//
// What bounds it: the wavefront's dependency.  A band's step is a chain of
// one word step (about 25 64-bit integer operations at g = 1, twice that at
// B = 3..4) and the shuffle, issued by one warp with nothing to hide its
// latency, so a step's time is its instructions' latency, not the card's
// integer rate; the bands run side by side, each about 32 + 2 kChunk
// columns behind the one above, so a launch takes about mt + nw + bands *
// 2 kChunk steps when every band has its block (bitpal.pipeline_plan).
// Bands of several warps (a block barrier a step) and lanes of two words or
// more measured slower at every shape on the H100 (tools/ab_bitpal_gfill.py),
// so a band is one warp of one word a lane.

#include "bitpal_band.cuh"

namespace {

constexpr int kChunk = 32;  // columns a fetch, a publish and a steady chunk
static_assert(kChunk == 32, "a warp fetches a chunk of kChunk columns, one a lane");

struct Fill {
  const int8_t* text;
  const u64* eq;
  int64_t mt;
  int nw;
  int vmax;
  const int32_t* cap_rows;  // (ncap,) ascending rows (CAP)
  int ncap;
  int8_t* caps;   // (ncap, mt) (CAP)
  u64* planes;    // (B, nw)
  uint8_t* ring;  // (depth, mt): a band's bottom h_out enc, a byte a column
  int* sync;      // zeroed (bands + 1,): the ticket, then progress[s]
  int bands;
  int depth;  // D, at least 2 when bands >= 2
};

// the code of text column col (1-based), kAlphabet outside 1..mt or 0..4
__device__ __forceinline__ unsigned code_at(const Fill& a, int64_t col) {
  const int c = (col >= 1 && col <= a.mt) ? a.text[col - 1] : kAlphabet;
  return (c >= 0 && c < kAlphabet) ? c : kAlphabet;
}

// One lane's part of a band: its word's state, and the chunks of the ring
// row above and of the text that lane 0 reads
template <int B>
struct Lane {
  int lane;     // also the word's position in the band
  bool bottom;  // the bottom lane of a band with a band below
  const uint8_t* in;  // the band above's bottom row, or null (band 0)
  uint8_t* out;       // this band's bottom row, or null (the last band)
  int* in_ready;
  int* out_ready;
  int* out_free;  // progress of the band that read out's row last, or null
  int seen;       // the last progress of the band above seen by this lane
  int free_to;    // bottom: columns of the out row known read
  unsigned ring_cur, ring_nxt;  // lane i holds column c0 + i's byte
  unsigned text_cur, text_nxt;  // lane i holds column c0 + 1 + i's code
  u64 e[kAlphabet];
  u64 V[B];
  u64 vm[B];
  unsigned hp;  // the word's h_out enc of the last step
  unsigned ci;  // the word's code at this step
  int clo, cn;  // the word's captures: cap_rows[clo .. clo + cn)
  int cbit;     // the bit of its first capture
};

// The first step d of a chunk (columns d .. d + 31): this chunk's bytes and
// codes move in, the next chunk's loads start
template <int B>
__device__ __forceinline__ void next_chunk(const Fill& a, Lane<B>& l, int64_t d) {
  l.ring_cur = l.ring_nxt;
  l.text_cur = l.text_nxt;
  const int64_t col = d + kChunk + l.lane;
  l.text_nxt = code_at(a, col + 1);
  if (l.in != nullptr && d + kChunk <= a.mt) {
    const int64_t need = d + 2 * kChunk - 1 < a.mt ? d + 2 * kChunk - 1 : a.mt;
    while (l.seen < need) l.seen = load_acquire(l.in_ready);
    if (col <= a.mt) l.ring_nxt = __ldcg(l.in + col - 1);
  }
}

// The word's step from h; where `live`, its column j is in 1..mt: the
// planes move and its captures are stored
template <int B, bool CAP>
__device__ __forceinline__ void word(const Fill& a, Lane<B>& l, unsigned h, int64_t j,
                                     bool live) {
  const u64 E = match(l.e, l.ci);
  u64 u[B], U[B], Vn[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    u[b] = (h >> b) & 1;
    Vn[b] = l.V[b];
  }
  if constexpr (B == 2) {
    plane_step(E, Vn[0], Vn[1], u[0], u[1], U[0], U[1]);
  } else {
    g_plane_step<B>(E, Vn, u, l.vm, U);
  }
  unsigned hn = 0;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    l.V[b] = live ? Vn[b] : l.V[b];
    hn |= static_cast<unsigned>(u[b]) << b;
  }
  l.hp = hn;
  if (CAP) {
    // the first capture predicated, the others (rows of one word) in a loop
    auto enc_of = [&](int bit) {
      unsigned enc = 0;
#pragma unroll
      for (int b = 0; b < B; ++b) enc |= static_cast<unsigned>((U[b] >> bit) & 1) << b;
      return static_cast<int8_t>(enc);
    };
    if (live && l.cn > 0) {
      a.caps[static_cast<int64_t>(l.clo) * a.mt + j - 1] = enc_of(l.cbit);
    }
    if (live && l.cn > 1) {
      for (int x = 1; x < l.cn; ++x) {
        const int cc = l.clo + x;
        a.caps[static_cast<int64_t>(cc) * a.mt + j - 1] = enc_of((a.cap_rows[cc] - 1) & 63);
      }
    }
  }
}

// Step d of a band, with every check: a chunk's first step fetches, and the
// word's column may lie outside 1..mt
template <int B, bool CAP>
__device__ __forceinline__ void step(const Fill& a, Lane<B>& l, int64_t d) {
  const int64_t mt = a.mt;
  if (((d - 1) & (kChunk - 1)) == 0 && d <= mt) next_chunk(a, l, d);
  // one shuffle: lane t > 0 takes lane t-1's h_out and its code (the code
  // of its own word at the next step); lane 0 the ring's byte of column d
  // (zero in band 0: the top boundary, enc 0) and the code of column d + 1,
  // from lane (d - 1) mod 32
  const unsigned mine = l.hp | (l.ci << 8) | (l.ring_cur << 16) | (l.text_cur << 24);
  const unsigned got = __shfl_sync(0xffffffffu, mine,
                                   l.lane ? l.lane - 1 : static_cast<int>((d - 1) & 31)) >>
                       (l.lane ? 0 : 16);
  const unsigned hin = got & 0xffu, nx = (got >> 8) & 0xffu;
  const int64_t j = d - l.lane;
  word<B, CAP>(a, l, hin, j, static_cast<uint64_t>(j - 1) < static_cast<uint64_t>(mt));
  if (l.bottom && j >= 1 && j <= mt) {
    // the band's bottom word (lane 31) at column j
    if (l.out_free != nullptr && l.free_to < j) {
      do {
        l.free_to = load_acquire(l.out_free);
      } while (l.free_to < j);
    }
    __stcg(l.out + j - 1, static_cast<uint8_t>(l.hp));
    if ((j & (kChunk - 1)) == 0 || j == mt) store_release(l.out_ready, static_cast<int>(j));
  }
  l.ci = nx;
}

// Steps c0 .. c0 + 31 of a band, c0 = 1 (mod 32), where every word's column
// lies in 1..mt: no branch in a step
template <int B, bool CAP>
__device__ __forceinline__ void chunk(const Fill& a, Lane<B>& l, int64_t c0) {
  next_chunk(a, l, c0);
  const int64_t j0 = c0 - 31;  // the bottom word's column at the first step
  if (l.bottom && l.out_free != nullptr && l.free_to < j0 + kChunk - 1) {
    do {
      l.free_to = load_acquire(l.out_free);
    } while (l.free_to < j0 + kChunk - 1);
  }
  const unsigned high = (l.ring_cur << 16) | (l.text_cur << 24);
  const int shift = l.lane ? 0 : 16;
#pragma unroll 8
  for (int q = 0; q < kChunk; ++q) {
    const unsigned got =
        __shfl_sync(0xffffffffu, l.hp | (l.ci << 8) | high, l.lane ? l.lane - 1 : q) >> shift;
    const unsigned hin = got & 0xffu, nx = (got >> 8) & 0xffu;
    word<B, CAP>(a, l, hin, c0 + q - l.lane, true);
    if (l.bottom) __stcg(l.out + j0 + q - 1, static_cast<uint8_t>(l.hp));
    l.ci = nx;
  }
  if (l.bottom) store_release(l.out_ready, static_cast<int>(j0 + kChunk - 1));
}

// One band: words 32s .. 32s + 31 of the query
template <int B, bool CAP>
__device__ __forceinline__ void band(const Fill& a, int s) {
  Lane<B> l;
  l.lane = threadIdx.x & 31;
  const int64_t mt = a.mt;
  const int nw = a.nw;
  const int w = s * 32 + l.lane;         // this lane's word
  const int real = min(32, nw - s * 32);  // the band's words
  const int64_t last = mt + real - 1;     // the step at which its last word ends
#pragma unroll
  for (int c = 0; c < kAlphabet; ++c) {
    l.e[c] = w < nw ? a.eq[c * static_cast<int64_t>(nw) + w] : 0;
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    l.V[b] = 0;  // column 0: v = -g, enc 0
    l.vm[b] = ((a.vmax >> b) & 1) ? ~0ull : 0ull;
  }
  l.hp = 0;
  l.ci = code_at(a, 1 - l.lane);
  l.cn = 0;
  if (CAP) {
    // the captured rows of word w, rows 64w + 1 .. 64w + 64, by binary search
    int lo = 0, hi = a.ncap;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.cap_rows[mid] <= 64 * w) lo = mid + 1; else hi = mid;
    }
    l.clo = lo;
    while (lo < a.ncap && a.cap_rows[lo] <= 64 * (w + 1)) ++lo;
    l.cn = lo - l.clo;
    l.cbit = l.cn ? (a.cap_rows[l.clo] - 1) & 63 : 0;
  }
  // the ring: the band above's bottom row in, this band's bottom row out
  l.in = s > 0 ? a.ring + static_cast<int64_t>((s - 1) % a.depth) * mt : nullptr;
  l.in_ready = a.sync + s;  // progress[s - 1]
  l.out = s + 1 < a.bands ? a.ring + static_cast<int64_t>(s % a.depth) * mt : nullptr;
  l.out_ready = a.sync + 1 + s;
  l.out_free = (l.out != nullptr && s >= a.depth) ? a.sync + 2 + s - a.depth : nullptr;
  l.bottom = l.out != nullptr && l.lane == 31;
  l.seen = 0;
  l.free_to = 0;
  l.ring_cur = l.ring_nxt = 0;
  l.text_cur = 0;
  l.text_nxt = code_at(a, 2 + l.lane);  // the first chunk's codes: columns 2 ..
  if (l.in != nullptr) {
    const int64_t need = mt < kChunk ? mt : kChunk;
    while (l.seen < need) l.seen = load_acquire(l.in_ready);
    if (l.lane < mt) l.ring_nxt = __ldcg(l.in + l.lane);
  }
  // whole chunks from the first chunk start at or past step `real` (from
  // there to step mt every word's column lies in 1..mt; the lanes past the
  // band's words feed only each other), steps with checks around them
  int64_t d = 1;
  const int64_t first = real + ((1 - real) & (kChunk - 1));
  for (; d < first && d <= last; ++d) step<B, CAP>(a, l, d);
  for (; d + kChunk - 1 <= mt; d += kChunk) chunk<B, CAP>(a, l, d);
  for (; d <= last; ++d) step<B, CAP>(a, l, d);
  if (w < nw) {
#pragma unroll
    for (int b = 0; b < B; ++b) a.planes[b * static_cast<int64_t>(nw) + w] = l.V[b];
  }
}

template <int B, bool CAP>
__global__ void __launch_bounds__(32) bitpal_gfill_kernel(const Fill a) {
  take_bands(a.sync, a.bands, [&](int s) { band<B, CAP>(a, s); });
}

template <int B, bool CAP>
int launch_b(int blocks, cudaStream_t s, const Fill& a) {
  bitpal_gfill_kernel<B, CAP><<<blocks, 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool CAP>
int launch(int g, int blocks, void* stream, Fill a) {
  // the progress flags are int32 column counts
  if (g < 1 || g > kMaxG || blocks < 1 || a.nw < 1 || a.mt < 0 || a.mt > 0x7fffffff ||
      a.ncap < 0 || a.sync == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.bands = (a.nw + 31) / 32;
  if (a.bands > 1 && (a.depth < 2 || a.ring == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  // B = bit length of vmax = 2g + 1
  if (g == 1) return launch_b<2, CAP>(blocks, s, a);
  if (g <= 3) return launch_b<3, CAP>(blocks, s, a);
  return launch_b<4, CAP>(blocks, s, a);
}

}  // namespace

// K1's (g = 1) and K2's contract: launches the fill on `stream` over
// `blocks` blocks of one warp, bands of 32 words; `ring` holds `depth` rows
// of mt bytes (at least 2 when there are two bands or more) and `sync`
// (bands + 1) int32, zeroed; writes the B final planes to `planes` (B, nw).
// Returns the cudaError_t of the launch; the fill itself runs
// asynchronously.
extern "C" int bitpal_gfill(const void* text, const void* eq, int64_t mt, int nw, int g,
                            int blocks, void* ring, int depth, void* sync, void* planes,
                            void* stream) {
  const Fill a{static_cast<const int8_t*>(text), static_cast<const u64*>(eq), mt, nw,
               2 * g + 1, nullptr, 0, nullptr, static_cast<u64*>(planes),
               static_cast<uint8_t*>(ring), static_cast<int*>(sync), 0, depth};
  return launch<false>(g, blocks, stream, a);
}

// K4's contract: as bitpal_gfill, and also writes the horizontal-delta enc
// of the ncap rows `cap_rows` (ascending, in 1..nq) at every column to
// `caps` (ncap, mt).
extern "C" int bitpal_capture_fill(const void* text, const void* eq, int64_t mt, int nw,
                                   int g, int blocks, void* ring, int depth, void* sync,
                                   const void* cap_rows, int ncap, void* caps, void* planes,
                                   void* stream) {
  const Fill a{static_cast<const int8_t*>(text), static_cast<const u64*>(eq), mt, nw,
               2 * g + 1, static_cast<const int32_t*>(cap_rows), ncap,
               static_cast<int8_t*>(caps), static_cast<u64*>(planes),
               static_cast<uint8_t*>(ring), static_cast<int*>(sync), 0, depth};
  return launch<true>(g, blocks, stream, a);
}
