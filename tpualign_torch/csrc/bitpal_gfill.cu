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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxThreads = 1024;
constexpr int kAlphabet = 5;
constexpr int kMaxG = 7;

// One g = 1 column step of one word.  (b0, b1): the word's vertical-delta
// planes (enc = v + 1), updated in place.  (u0, u1): enc of the horizontal
// delta entering the top row; on return, enc of the h_out leaving the
// bottom row.  (U0, U1): on return, enc of the h_out of every row of the
// word, the horizontal delta H(i, j) - H(i, j-1) that a capture reads.
// Carries out of bit 63 are dropped: the bottom row's promotion reaches the
// next word through h_out, not through the add.
__device__ __forceinline__ void plane_step(u64 E, u64& b0, u64& b1, u64& u0,
                                           u64& u1, u64& U0, u64& U1) {
  const u64 vm1 = ~b0 & ~b1;  // v = -1
  const u64 received = (vm1 + (E & vm1) + (u0 & u1)) ^ vm1;
  const u64 P = E | (b0 & b1) | received;  // promotion bit
  U0 = (P & ~b0) | (~P & b0 & ~b1);
  U1 = (P & ~b1) | (~P & vm1);
  const u64 U0i = (U0 << 1) | u0;
  const u64 U1i = (U1 << 1) | u1;
  b0 = U0i ^ P;
  b1 = ~(U0i ^ U1i) ^ (U0i & P);
  u0 = U0 >> 63;
  u1 = U1 >> 63;
}

// x += c (mod 2^B), c a constant given as B planes of all ones or zeros.
template <int B>
__device__ __forceinline__ void add_const(u64 (&x)[B], const u64 (&c)[B]) {
  u64 carry = 0;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const u64 s = x[b] ^ c[b] ^ carry;
    carry = (x[b] & c[b]) | (carry & (x[b] ^ c[b]));
    x[b] = s;
  }
}

// x += p (mod 2^B), p a single bit plane.
template <int B>
__device__ __forceinline__ void add_bit(u64 (&x)[B], u64 p) {
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const u64 s = x[b] ^ p;
    p &= x[b];
    x[b] = s;
  }
}

// One column step of one word under (1, 0, -g), g >= 2: the port of
// tpualign/ops/bitpal.py:_g_plane_step with 64-bit words.  V: the word's B
// vertical-delta planes, updated in place.  u: enc bits (0 or 1) of the
// h_top entering the top row; on return, of the h_out leaving the bottom
// row.  vm: vmax = 2g + 1 as B planes of all ones or zeros.  U: on return,
// the B planes of every row's h_out enc.
template <int B>
__device__ __forceinline__ void g_plane_step(u64 E, u64 (&V)[B], u64 (&u)[B],
                                             const u64 (&vm)[B],
                                             u64 (&U)[B]) {
  u64 is0 = ~0ull;    // enc_v == 0, i.e. v = -g
  u64 ismax = ~0ull;  // enc_v == vmax, i.e. v = 1 + g
  u64 cin = 1;        // h_top == 1 + g: the promotion enters from above
#pragma unroll
  for (int b = 0; b < B; ++b) {
    U[b] = ~V[b];
    is0 &= U[b];
    ismax &= V[b] ^ ~vm[b];
    cin &= u[b] ^ ~vm[b];
  }
  const u64 received = (is0 + (E & is0) + (cin & 1)) ^ is0;
  const u64 P = E | ismax | received;  // promotion bit
  // h_out enc = vmax + ~enc_v + P = 2g - enc_v + P (mod 2^B)
  add_const<B>(U, vm);
  add_bit<B>(U, P);
  // v_out enc = 2g - enc_h_in + P, h_in = every row's h_out shifted down
  // one row, the word's h_top entering row 0
#pragma unroll
  for (int b = 0; b < B; ++b) V[b] = ~((U[b] << 1) | u[b]);
  add_const<B>(V, vm);
  add_bit<B>(V, P);
#pragma unroll
  for (int b = 0; b < B; ++b) u[b] = U[b] >> 63;
}

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
