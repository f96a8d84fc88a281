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
// that part of its contract waits for the port's sharded pipeline.  Its
// capture is per word bottom (row 31(w+1)) and staggered 2w steps; here any
// row can be captured, since every row's h_out is at hand in the U planes,
// and entry j-1 of a capture stream is column j.
//
// Query rows are packed 64 to a word (row 64w+b is bit b of word w).
// Schedule: one thread block; thread t owns words
// [t*K, t*K+K), keeps their B delta planes in registers, computes column
// j = d - t at step d for all of its words, and hands the B-bit h_out of its
// last word to thread t+1 through a parity double buffer in shared memory;
// one __syncthreads() per step.  A capture is written by the thread that
// owns its row's word, one int8 store per live column.
//
// What bounds it: one SM issues every word step (about 25 64-bit integer
// ops at g = 1, twice that at B = 3..4) plus a block-wide barrier per step;
// the other SMs idle.  At K = 16 words per thread the B planes no longer
// fit the 64 registers a thread has under 1024 threads and spill.  Later
// work: a multi-block wavefront (blocks own word bands and hand the band's
// bottom h_out stream to the next block through global memory with flags),
// warp-shuffle hand-offs, and staging the capture bytes in shared memory
// for wide stores.

#include "bitpal_step.cuh"

namespace {

template <int K, int B, bool CAP>
__global__ void __launch_bounds__(kMaxThreads)
    bitpal_gfill_kernel(const int8_t* __restrict__ text,
                        const u64* __restrict__ eq, int64_t mt, int nw,
                        int vmax, const int32_t* __restrict__ cap_rows,
                        int ncap, int8_t* __restrict__ caps,
                        u64* __restrict__ planes) {
  __shared__ uint8_t hand[2][kMaxThreads];
  const int t = threadIdx.x;
  const int w0 = t * K;
  u64 V[K][B];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int b = 0; b < B; ++b) V[i][b] = 0;  // column 0: v = -g, enc 0
  }
  u64 vm[B];
#pragma unroll
  for (int b = 0; b < B; ++b) vm[b] = ((vmax >> b) & 1) ? ~0ull : 0ull;
  // this thread's captures: cap_rows[c_lo..c_hi) lie in its words
  int c_lo = 0, c_hi = 0;
  if (CAP) {
    while (c_lo < ncap && (cap_rows[c_lo] - 1) / 64 < w0) ++c_lo;
    c_hi = c_lo;
    while (c_hi < ncap && (cap_rows[c_hi] - 1) / 64 < w0 + K) ++c_hi;
  }

  const int64_t steps = mt + blockDim.x - 1;
  for (int64_t d = 1; d <= steps; ++d) {
    const int64_t j = d - t;
    if (j >= 1 && j <= mt) {
      const int c = text[j - 1];
      // word 0's h_top is the top boundary h = -g: enc 0
      const unsigned h = t > 0 ? hand[(d - 1) & 1][t - 1] : 0u;
      u64 u[B];
#pragma unroll
      for (int b = 0; b < B; ++b) u[b] = (h >> b) & 1;
      const bool known = c >= 0 && c < kAlphabet;
      const u64* e = eq + (known ? c : 0) * static_cast<int64_t>(nw) + w0;
      int cc = c_lo;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const u64 E = (known && w0 + i < nw) ? e[i] : 0;
        u64 U[B];
        if constexpr (B == 2) {
          plane_step(E, V[i][0], V[i][1], u[0], u[1], U[0], U[1]);
        } else {
          g_plane_step<B>(E, V[i], u, vm, U);
        }
        if (CAP) {
          for (; cc < c_hi && (cap_rows[cc] - 1) / 64 == w0 + i; ++cc) {
            const int bit = (cap_rows[cc] - 1) & 63;
            unsigned enc = 0;
#pragma unroll
            for (int b = 0; b < B; ++b) {
              enc |= static_cast<unsigned>((U[b] >> bit) & 1) << b;
            }
            caps[static_cast<int64_t>(cc) * mt + j - 1] =
                static_cast<int8_t>(enc);
          }
        }
      }
      unsigned hv = 0;
#pragma unroll
      for (int b = 0; b < B; ++b) hv |= static_cast<unsigned>(u[b]) << b;
      hand[d & 1][t] = static_cast<uint8_t>(hv);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (w0 + i < nw) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        planes[b * static_cast<int64_t>(nw) + w0 + i] = V[i][b];
      }
    }
  }
}

struct Args {
  const int8_t* text;
  const u64* eq;
  int64_t mt;
  int nw;
  int vmax;
  const int32_t* cap_rows;
  int ncap;
  int8_t* caps;
  u64* planes;
};

template <int B, bool CAP>
int launch_k(int k, int threads, cudaStream_t s, const Args& a) {
  switch (k) {
#define GFILL_CASE(K)                                                        \
  case K:                                                                    \
    bitpal_gfill_kernel<K, B, CAP><<<1, threads, 0, s>>>(                   \
        a.text, a.eq, a.mt, a.nw, a.vmax, a.cap_rows, a.ncap, a.caps,        \
        a.planes);                                                           \
    break;
    GFILL_CASE(1)
    GFILL_CASE(2)
    GFILL_CASE(4)
    GFILL_CASE(8)
    GFILL_CASE(16)
#undef GFILL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool CAP>
int launch(int g, int k, int threads, void* stream, const Args& a) {
  if (g < 1 || g > kMaxG || threads < 1 || threads > kMaxThreads ||
      static_cast<int64_t>(threads) * k < a.nw || a.ncap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  // B = bit length of vmax = 2g + 1
  if (g == 1) return launch_k<2, CAP>(k, threads, s, a);
  if (g <= 3) return launch_k<3, CAP>(k, threads, s, a);
  return launch_k<4, CAP>(k, threads, s, a);
}

}  // namespace

// K1's (g = 1) and K2's contract: launches the fill on `stream` with `threads` threads of k
// words each (threads * k >= nw, threads <= 1024, k in {1, 2, 4, 8, 16});
// writes the B final planes to `planes` (B, nw).  Returns the cudaError_t of
// the launch; the fill itself runs asynchronously.
extern "C" int bitpal_gfill(const void* text, const void* eq, int64_t mt,
                            int nw, int g, int k, int threads, void* planes,
                            void* stream) {
  const Args a{static_cast<const int8_t*>(text), static_cast<const u64*>(eq),
               mt, nw, 2 * g + 1, nullptr, 0, nullptr,
               static_cast<u64*>(planes)};
  return launch<false>(g, k, threads, stream, a);
}

// K4's contract: as bitpal_gfill, and also writes the horizontal-delta enc
// of the ncap rows `cap_rows` (ascending, in 1..nq) at every column to
// `caps` (ncap, mt).
extern "C" int bitpal_capture_fill(const void* text, const void* eq,
                                   int64_t mt, int nw, int g, int k,
                                   int threads, const void* cap_rows,
                                   int ncap, void* caps, void* planes,
                                   void* stream) {
  const Args a{static_cast<const int8_t*>(text), static_cast<const u64*>(eq),
               mt, nw, 2 * g + 1, static_cast<const int32_t*>(cap_rows),
               ncap, static_cast<int8_t*>(caps), static_cast<u64*>(planes)};
  return launch<true>(g, k, threads, stream, a);
}
