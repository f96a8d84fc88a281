// The band body of bitpal_gfill.cu's pipelined wavefront (K1, K2 and
// K4's captures: one warp a band of 32 words, one word a lane, the band's
// bottom h_out stream handed down through a ring of a byte a column with
// progress flags), which bitpal_gfill.cu states.  bitpal_batch.cu (K5)
// runs it on each long pair of a batch, a Fill a pair.

#pragma once

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

}  // namespace
