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

#include "bitpal_gband.cuh"

namespace {

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
