// Bit-parallel (1, 0, -g) fills whose words trail each other by one step:
// the g = 1 fill at RC = 2..4 text columns a step, and resumable chunks of
// it and of the one-column fill at any g.
//
// Replaces three contracts of tpualign/ops/bitpal.py:
//   _rc_kernel_body       (K3a): the g = 1 final column, rc columns a step;
//   _rc_chunk_kernel_body (K3b): K3a resumed over a chunk of steps, its
//                                state carried in and out;
//   _chunk_kernel_body    (K4):  the state in and out of the g-family chunk
//                                (word 0's h_top the constant boundary, as
//                                _score_chunked_fn passes it; the upstream
//                                stream and the tail capture of the sharded
//                                pipeline are not part of this port).
// Contract, word for word the same as _wave_plain in
// tpualign_torch/ops/bitpal.py (fill_rc_plain, chunk_plain):
//
//   in:  text     (mt,)     int8, codes 0..4 (other codes match nothing),
//                           the whole text: a step reads the columns its
//                           words' windows cover
//        eq       (5, nw)   uint64, bit b of eq[c][w] set iff
//                           query[64w+b] == c
//        t0, t1             the steps t0+1 .. t1 to run
//        v_in     (B, nw)   uint64, the planes of the state in (chunks)
//        h_in     (nw,)     uint8, the hand-offs of the state in (chunks)
//   out: v_out    (B, nw)   uint64, the planes after step t1: at the last
//                           step, the final column's v(i, mt) as B planes
//                           of enc = v + g
//        h_out    (nw,)     uint8 (chunks): each word's h_out enc at step
//                           t1, RC columns of B bits, column c at bit c*B
//
// Schedule: word w at step t advances its window s = t - 1 - w, columns
// RC*s + 1 .. RC*s + RC in turn, each column's h_top the h_out word w - 1
// produced for it one step earlier (K3a's in-lane stagger: a word trails
// its predecessor by one step, so one synchronisation covers RC columns);
// word 0's h_top is the top boundary h = -g, enc 0.  Columns outside
// 1..mt leave the planes as they are.  A fill runs ceil(mt/RC) + nw - 1
// steps; a chunk's state is every word's planes and last hand-off, so any
// split of the steps gives the one launch's planes.
//
// On the card: a pipelined wavefront over many thread blocks of one warp,
// as bitpal_gfill.cu's, on this contract's own clock.  The words are cut
// into bands of 32 words, one warp a band, one word a lane; every band runs
// every step t0+1 .. t1 of the launch (the k-th of them its step k), lane t
// taking lane t-1's hand-off of the last step through one warp shuffle that
// also carries lane t-1's window codes, which lane t reads one step later.
// A band's bottom word hands its packed h_out (RC*B <= 8 bits, one byte a
// step) down to the next band through a ring of D rows of n = t1 - t0
// bytes in global memory: band s writes byte k-1 of row s mod D at its
// step k and publishes progress[s] = k with release semantics every 32
// steps and at step n; lane 0 of band s+1 takes byte k-2 at its step k
// (the bottom word's hand-off of the step before), and its first step's
// h_top from h_in[32(s+1) - 1], the state in.  The band fetches the ring
// bytes and its lane 0's window codes a chunk of 32 steps at a time, one
// step a lane, the next chunk's loads in flight while this one is read
// (each lane acquires until the chunk's steps are published, and loads
// through L2).  Before it writes byte k-1 of a reused row the bottom lane
// waits until progress[s-D+1] >= min(k + 1, n): the band that reads the
// row's old contents has consumed that byte, so any D >= 2 is correct.
// Blocks take bands in order from an atomic ticket, so a band only ever
// waits on a lower band, which a running block holds: no grid size
// deadlocks.  The dead steps, before a word's first window and past its
// last, run as the contract's do (no match, the planes held) and hand
// their h_out on: the state's hand-offs include them.
//
// The steady part of a band, where every lane's window lies in 1..mt, runs
// a chunk of 32 steps at a time without a branch in a step (the shuffle's
// source at a constant phase, the bottom lane's store predicated); the
// fetch, the backpressure wait and the publish run once a chunk.  The
// steps around it run one at a time, with their checks.  A lane's 5 match
// words live in registers, and no step loads from global memory.
//
// Why not bitpal_gfill.cu's band body: there each band runs only its own
// columns, from its own first step, and its ring holds a byte a column;
// here every band runs every step of the chunk from one t0 (the state's
// hand-offs of the dead steps are part of the contract) and its ring a
// byte a step.  Sharing one body would put those offsets into K1's steady
// loop, which is latency-bound (such a body was not built or timed); the
// two files share only bitpal_band.cuh (the flags' release/acquire, the
// match word and the ticket).
//
// What bounds it: the wavefront's dependency.  A band's step is a chain of
// RC word-column steps (about 25 64-bit integer operations each at g = 1,
// twice that at B = 3..4) and one shuffle, issued by one warp with nothing
// to hide its latency; the bands run side by side, each about 64 steps
// behind the one above, so a launch takes about n + 64 bands steps when
// every band has its block (bitpal.pipeline_plan).

#include "bitpal_band.cuh"

#include <type_traits>

namespace {

constexpr int kChunk = 32;  // steps a fetch, a publish and a steady chunk
static_assert(kChunk == 32, "a warp fetches a chunk of kChunk steps, one a lane");
constexpr int kCodeBits = 4;  // a column's code in the packed window

struct Wave {
  const int8_t* text;
  const u64* eq;
  int64_t mt;
  int nw;
  int vmax;
  int64_t t0;  // the launch runs steps t0+1 .. t0+n
  int n;
  const u64* v_in;      // (B, nw) (STATE)
  const uint8_t* h_in;  // (nw,) (STATE)
  u64* v_out;           // (B, nw)
  uint8_t* h_out;       // (nw,) (STATE)
  uint8_t* ring;        // (depth, n): a band's bottom h_out, a byte a step
  int* sync;            // zeroed (bands + 1,): the ticket, then progress[s]
  int bands;
  int depth;  // D, at least 2 when bands >= 2
};

// the codes of window s (columns RC*s + 1 .. RC*s + RC), kCodeBits a column,
// kAlphabet where a column lies outside 1..mt or holds no code 0..4
template <int RC>
__device__ __forceinline__ unsigned window_codes(const Wave& a, int64_t s) {
  unsigned packed = 0;
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    const int64_t col = RC * s + c + 1;
    int code = (col >= 1 && col <= a.mt) ? a.text[col - 1] : kAlphabet;
    code = (code >= 0 && code < kAlphabet) ? code : kAlphabet;
    packed |= static_cast<unsigned>(code) << (kCodeBits * c);
  }
  return packed;
}

// One lane's part of a band: its word's state, and the chunks of the ring
// row above and of the windows that lane 0 reads
template <int RC, int B>
struct Lane {
  // the shuffle's word: the hand-off and the codes in the low half, lane
  // 0's ring byte and codes in the high half
  using Word = std::conditional_t<(8 + kCodeBits * RC <= 16), unsigned, u64>;
  static constexpr int kHalf = 4 * sizeof(Word);
  int lane;     // also the word's position in the band
  bool bottom;  // the bottom lane of a band with a band below
  int64_t base;  // lane 0's window at step k is base + k - 1
  const uint8_t* in;  // the band above's bottom row, or null (band 0)
  uint8_t* out;       // this band's bottom row, or null (the last band)
  int* in_ready;
  int* out_ready;
  int* out_free;  // progress of the band that read out's row last, or null
  int seen;       // the last progress of the band above seen by this lane
  int free_to;    // bottom: progress of the out row's last reader seen
  unsigned h0;    // lane 0's h_top at step 1: the state in, 0 in band 0
  unsigned ring_cur, ring_nxt;  // lane i: lane 0's h_top at step c0 + i
  unsigned text_cur, text_nxt;  // lane i: lane 0's codes at step c0 + i + 1
  u64 e[kAlphabet];
  u64 V[B];
  u64 vm[B];
  unsigned hp;  // the word's h_out of the last step, column c at bit c*B
  unsigned ci;  // the word's codes at this step
};

// Fetch the chunk of steps c .. c + 31 into the lanes' *_nxt: lane i's
// ring byte is lane 0's h_top at step c + i (byte c + i - 2 of the row
// above, h0 at step 1), its codes lane 0's at step c + i + 1
template <int RC, int B>
__device__ __forceinline__ void fetch(const Wave& a, Lane<RC, B>& l, int c) {
  const int k = c + l.lane;
  l.text_nxt = window_codes<RC>(a, l.base + k);
  unsigned r = k == 1 ? l.h0 : 0u;
  if (l.in != nullptr) {
    const int need = min(c + kChunk - 1, a.n) - 1;
    while (l.seen < need) l.seen = load_acquire(l.in_ready);
    if (k >= 2 && k <= a.n) r = __ldcg(l.in + k - 2);
  }
  l.ring_nxt = r;
}

// The first step c of a chunk: this chunk's bytes and codes move in, the
// next chunk's loads start
template <int RC, int B>
__device__ __forceinline__ void next_chunk(const Wave& a, Lane<RC, B>& l, int c) {
  l.ring_cur = l.ring_nxt;
  l.text_cur = l.text_nxt;
  if (c + kChunk <= a.n) fetch(a, l, c + kChunk);
}

// The word's step from the hand-off h: RC columns of window s in turn;
// with CHECK a column outside 1..mt leaves the planes as they are
template <int RC, int B, bool CHECK>
__device__ __forceinline__ void word(const Wave& a, Lane<RC, B>& l, unsigned h, int64_t s) {
  unsigned hn = 0;
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    const u64 E = match(l.e, (l.ci >> (kCodeBits * c)) & ((1u << kCodeBits) - 1));
    u64 u[B], U[B], Vn[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      u[b] = (h >> (c * B + b)) & 1;
      Vn[b] = l.V[b];
    }
    if constexpr (B == 2) {
      plane_step(E, Vn[0], Vn[1], u[0], u[1], U[0], U[1]);
    } else {
      g_plane_step<B>(E, Vn, u, l.vm, U);
    }
    const bool live =
        !CHECK || static_cast<uint64_t>(RC * s + c) < static_cast<uint64_t>(a.mt);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      l.V[b] = live ? Vn[b] : l.V[b];
      hn |= static_cast<unsigned>(u[b]) << (c * B + b);
    }
  }
  l.hp = hn;
}

// the hand-off and the codes this step needs: lane t > 0 takes lane t-1's
// of the last step, lane 0 the ring's byte and codes held by lane q
template <int RC, int B>
__device__ __forceinline__ typename Lane<RC, B>::Word shuffle(Lane<RC, B>& l,
                                                             typename Lane<RC, B>::Word high,
                                                             int q) {
  using Word = typename Lane<RC, B>::Word;
  const Word mine = static_cast<Word>(l.hp | (l.ci << 8)) | (high << Lane<RC, B>::kHalf);
  return __shfl_sync(0xffffffffu, mine, l.lane ? l.lane - 1 : q) >>
         (l.lane ? 0 : Lane<RC, B>::kHalf);
}

// Step k of a band, with every check: a chunk's first step fetches, the
// word's columns may lie outside 1..mt, and the bottom lane may wait for
// its row
template <int RC, int B>
__device__ __forceinline__ void step(const Wave& a, Lane<RC, B>& l, int k) {
  using Word = typename Lane<RC, B>::Word;
  if (((k - 1) & (kChunk - 1)) == 0) next_chunk(a, l, k);
  const Word got = shuffle(l, static_cast<Word>(l.ring_cur | (l.text_cur << 8)),
                           (k - 1) & (kChunk - 1));
  const unsigned h = static_cast<unsigned>(got) & 0xffu;
  const unsigned nx = static_cast<unsigned>(got >> 8) & ((1u << (kCodeBits * RC)) - 1);
  word<RC, B, true>(a, l, h, l.base + k - 1 - l.lane);
  if (l.bottom) {
    const int need = min(k + 1, a.n);
    if (l.out_free != nullptr && l.free_to < need) {
      do {
        l.free_to = load_acquire(l.out_free);
      } while (l.free_to < need);
    }
    __stcg(l.out + k - 1, static_cast<uint8_t>(l.hp));
    if ((k & (kChunk - 1)) == 0 || k == a.n) store_release(l.out_ready, k);
  }
  l.ci = nx;
}

// Steps c .. c + 31 of a band, c = 1 (mod 32), where every lane's window
// lies in 1..mt: no branch in a step
template <int RC, int B>
__device__ __forceinline__ void chunk(const Wave& a, Lane<RC, B>& l, int c) {
  using Word = typename Lane<RC, B>::Word;
  next_chunk(a, l, c);
  if (l.bottom && l.out_free != nullptr) {
    const int need = min(c + kChunk, a.n);
    while (l.free_to < need) l.free_to = load_acquire(l.out_free);
  }
  const Word high = static_cast<Word>(l.ring_cur | (l.text_cur << 8));
#pragma unroll 8
  for (int q = 0; q < kChunk; ++q) {
    const Word got = shuffle(l, high, q);
    const unsigned h = static_cast<unsigned>(got) & 0xffu;
    const unsigned nx = static_cast<unsigned>(got >> 8) & ((1u << (kCodeBits * RC)) - 1);
    word<RC, B, false>(a, l, h, 0);
    if (l.bottom) __stcg(l.out + c + q - 1, static_cast<uint8_t>(l.hp));
    l.ci = nx;
  }
  if (l.bottom) store_release(l.out_ready, c + kChunk - 1);
}

// One band: words 32s .. 32s + 31 of the query, steps 1 .. n of the launch
// from the state in (STATE) or from the column-0 boundary
template <int RC, int B, bool STATE>
__device__ __forceinline__ void band(const Wave& a, int s) {
  Lane<RC, B> l;
  l.lane = threadIdx.x & 31;
  const int nw = a.nw, n = a.n;
  const int w = s * 32 + l.lane;  // this lane's word
  const bool real = w < nw;
#pragma unroll
  for (int c = 0; c < kAlphabet; ++c) {
    l.e[c] = real ? a.eq[c * static_cast<int64_t>(nw) + w] : 0;
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    l.V[b] = (STATE && real) ? a.v_in[b * static_cast<int64_t>(nw) + w] : 0;
    l.vm[b] = ((a.vmax >> b) & 1) ? ~0ull : 0ull;
  }
  l.hp = (STATE && real) ? a.h_in[w] : 0u;
  l.h0 = (STATE && s > 0) ? a.h_in[32 * s - 1] : 0u;
  l.base = a.t0 - 32 * static_cast<int64_t>(s);
  l.ci = window_codes<RC>(a, l.base - l.lane);  // the word's window at step 1
  // the ring: the band above's bottom row in, this band's bottom row out
  l.in = s > 0 ? a.ring + static_cast<int64_t>((s - 1) % a.depth) * n : nullptr;
  l.in_ready = a.sync + s;  // progress[s - 1]
  l.out = s + 1 < a.bands ? a.ring + static_cast<int64_t>(s % a.depth) * n : nullptr;
  l.out_ready = a.sync + 1 + s;
  l.out_free = (l.out != nullptr && s >= a.depth) ? a.sync + 2 + s - a.depth : nullptr;
  l.bottom = l.out != nullptr && l.lane == 31;
  l.seen = 0;
  l.free_to = 0;
  l.ring_cur = l.text_cur = 0;
  l.ring_nxt = l.text_nxt = 0;
  if (n >= 1) fetch(a, l, 1);
  // whole chunks over the steps where every lane's window is one of the
  // text's whole windows 0 .. mt/RC - 1, steps with checks around them
  const int64_t lo = 32 - l.base, hi = a.mt / RC - l.base;
  const int64_t first = lo <= 1 ? 1 : lo + ((1 - lo) & (kChunk - 1));
  const int last = static_cast<int>(hi < 0 ? 0 : hi < n ? hi : n);
  int k = 1;
  for (; k < first && k <= n; ++k) step(a, l, k);
  for (; k + kChunk - 1 <= last; k += kChunk) chunk(a, l, k);
  for (; k <= n; ++k) step(a, l, k);
  if (real) {
#pragma unroll
    for (int b = 0; b < B; ++b) a.v_out[b * static_cast<int64_t>(nw) + w] = l.V[b];
    if (STATE) a.h_out[w] = static_cast<uint8_t>(l.hp);
  }
}

template <int RC, int B, bool STATE>
__device__ __forceinline__ void wave(const Wave& a) {
  take_bands(a.sync, a.bands, [&](int s) { band<RC, B, STATE>(a, s); });
}

// K3a's port: g = 1, RC columns a step, from the boundary to the end.
template <int RC>
__global__ void __launch_bounds__(32) bitpal_rc_kernel(const Wave a) {
  wave<RC, 2, false>(a);
}

// K3b's port (RC > 1, B = 2) and K4's state in and out (RC = 1): one chunk.
template <int RC, int B>
__global__ void __launch_bounds__(32) bitpal_chunk_kernel(const Wave a) {
  wave<RC, B, true>(a);
}

// the checks every entry makes; fills in the bands
bool bad_launch(Wave& a, int blocks, int64_t steps) {
  if (blocks < 1 || a.nw < 1 || a.mt < 0 || a.t0 < 0 || steps < 0 || steps > 0x7fffffff ||
      a.sync == nullptr) {
    return true;
  }
  a.n = static_cast<int>(steps);
  a.bands = (a.nw + 31) / 32;
  return a.bands > 1 && (a.depth < 2 || a.ring == nullptr);
}

template <int RC, int B, bool STATE>
int launch(int blocks, void* stream, const Wave& a) {
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (STATE) {
    bitpal_chunk_kernel<RC, B><<<blocks, 32, 0, s>>>(a);
  } else {
    bitpal_rc_kernel<RC><<<blocks, 32, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

Wave wave_args(const void* text, const void* eq, int64_t mt, int nw, int vmax, void* ring,
               int depth, void* sync, int64_t t0, const void* v_in, const void* h_in,
               void* v_out, void* h_out) {
  return Wave{static_cast<const int8_t*>(text), static_cast<const u64*>(eq), mt, nw, vmax, t0,
              0, static_cast<const u64*>(v_in), static_cast<const uint8_t*>(h_in),
              static_cast<u64*>(v_out), static_cast<uint8_t*>(h_out),
              static_cast<uint8_t*>(ring), static_cast<int*>(sync), 0, depth};
}

}  // namespace

// K3a's contract: launches the g = 1 fill at rc = 2..4 columns a step on
// `stream` over `blocks` blocks of one warp, bands of 32 words; it runs
// ceil(mt/rc) + nw - 1 steps (at most 2^31 - 1); `ring` holds `depth` rows
// of that many bytes (at least 2 when there are two bands or more) and
// `sync` (bands + 1) int32, zeroed; writes the two final planes to
// `planes` (2, nw).  Returns the cudaError_t of the launch; the fill itself
// runs asynchronously.
extern "C" int bitpal_rc_fill(const void* text, const void* eq, int64_t mt, int nw, int rc,
                              int blocks, void* ring, int depth, void* sync, void* planes,
                              void* stream) {
  Wave a = wave_args(text, eq, mt, nw, 3, ring, depth, sync, 0, nullptr, nullptr, planes,
                     nullptr);
  const int64_t steps = rc >= 1 ? (mt + rc - 1) / rc + nw - 1 : -1;
  if (bad_launch(a, blocks, steps)) return static_cast<int>(cudaErrorInvalidValue);
  if (rc == 2) return launch<2, 2, false>(blocks, stream, a);
  if (rc == 3) return launch<3, 2, false>(blocks, stream, a);
  if (rc == 4) return launch<4, 2, false>(blocks, stream, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3b's contract: steps t0+1 .. t0+t_steps (t_steps in 1..2^31 - 1) of
// K3a's fill at rc = 2..4 from the state (v_in (2, nw), h_in (nw,)); writes
// the state after them to (v_out, h_out).  The ring's rows hold t_steps
// bytes; blocks, ring, depth and sync as bitpal_rc_fill's.
extern "C" int bitpal_rc_chunk(const void* text, const void* eq, int64_t mt, int nw, int rc,
                               int blocks, void* ring, int depth, void* sync, int64_t t0,
                               int64_t t_steps, const void* v_in, const void* h_in,
                               void* v_out, void* h_out, void* stream) {
  Wave a = wave_args(text, eq, mt, nw, 3, ring, depth, sync, t0, v_in, h_in, v_out, h_out);
  if (t_steps < 1 || bad_launch(a, blocks, t_steps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc == 2) return launch<2, 2, true>(blocks, stream, a);
  if (rc == 3) return launch<3, 2, true>(blocks, stream, a);
  if (rc == 4) return launch<4, 2, true>(blocks, stream, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4's state in and out: steps t0+1 .. t0+t_steps of the (1, 0, -g) fill
// at one column a step, g = 1..7, from the state (v_in (B, nw), h_in (nw,))
// to (v_out, h_out), B = bit length of 2g + 1.  Launch as
// bitpal_rc_chunk's.
extern "C" int bitpal_gfill_chunk(const void* text, const void* eq, int64_t mt, int nw, int g,
                                  int blocks, void* ring, int depth, void* sync, int64_t t0,
                                  int64_t t_steps, const void* v_in, const void* h_in,
                                  void* v_out, void* h_out, void* stream) {
  Wave a = wave_args(text, eq, mt, nw, 2 * g + 1, ring, depth, sync, t0, v_in, h_in, v_out,
                     h_out);
  if (t_steps < 1 || g < 1 || g > kMaxG || bad_launch(a, blocks, t_steps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g == 1) return launch<1, 2, true>(blocks, stream, a);
  if (g <= 3) return launch<1, 3, true>(blocks, stream, a);
  return launch<1, 4, true>(blocks, stream, a);
}
